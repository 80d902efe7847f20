"""The port's DAGs (``ray_tpu_torch.dag``) against the reference's: the
channels of tests/test_dag.py (:28, :39, :57, :70), its interpreted cases
(:84, :98, :120) and more of the node kinds, and its compiled graphs over
thread actors (:139 to :293, :329, :346), its shared-memory channel (:304)
and its compiled graphs over process actors (:379), mixed tiers (:415) and
a process actor's error (:446), on both packages. Then the port's own:
``with_tensor_transport`` without a device and on a process edge, the
``dag_channel`` pool and transfer ledger, teardown leaving no element in the
arena, a CPU tensor staying on the CPU across a process edge, and GPT-2
tiny split over two thread actors and over two process actors and compiled,
against the port's whole forward and the JAX package's, with
``examples/pp_inference_dag.py`` at its tiny size.

Each parity case runs on the reference, then on the port, each in a runtime
of its own (tests/_torch_train_parity.py); the observations must be equal.
Where the reference places a jax array on a CPU device, the port's
``DeviceChannel`` places a tensor on ``device="cpu"``: the values and the
device's kind are compared.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both, raises

INIT = {"num_cpus": 8}


def _dag(pkg):
    return importlib.import_module(pkg.__name__ + ".dag")


def _parity(case):
    ref, port = both(case, init=INIT)
    assert_same(ref, port, atol=0)
    return port


# ---------------------------------------------------- tests/test_dag.py:84
def _function_dag(pkg):
    @pkg.remote
    def add(a, b):
        return a + b

    @pkg.remote
    def mul(a, b):
        return a * b

    with _dag(pkg).InputNode() as inp:
        dag = mul.bind(add.bind(inp, 1), 10)
    return pkg.get(dag.execute(4))


def test_function_dag_interpreted():
    assert _parity(_function_dag) == 50


# ---------------------------------------------------- tests/test_dag.py:98
def _diamond(pkg):
    calls = []

    @pkg.remote
    class Counter:
        def bump(self, x):
            calls.append(x)
            return x + 1

    c = Counter.remote()
    with _dag(pkg).InputNode() as inp:
        mid = c.bump.bind(inp)

        @pkg.remote
        def pair(a, b):
            return (a, b)

        dag = pair.bind(mid, mid)
    return pkg.get(dag.execute(1)), len(calls)


def test_diamond_dedup():
    assert _parity(_diamond) == [[2, 2], 1]  # diamond evaluated once


# --------------------------------------------------- tests/test_dag.py:120
def _class_node(pkg):
    made = []

    @pkg.remote
    class Adder:
        def __init__(self, base):
            made.append(base)
            self.base = base

        def add(self, x):
            return self.base + x

    node = Adder.bind(100)
    with _dag(pkg).InputNode() as inp:
        dag = node.add.bind(inp)
    return pkg.get(dag.execute(5)), pkg.get(dag.execute(7)), made


def test_class_node_lazy_actor():
    # the same actor reused: one constructor call
    assert _parity(_class_node) == [105, 107, [100]]


# ----------------------------------------------------- the other node kinds
def _inputs_and_outputs(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    def sub(a, b):
        return a - b

    @pkg.remote
    def scale(x, k=1):
        return x * k

    @pkg.remote
    def ident(x):
        return x

    with dag_mod.InputNode() as inp:
        pos = sub.bind(inp[0], inp[1])
    with dag_mod.InputNode() as inp:
        kw = scale.bind(inp.x, k=inp.k)
    with dag_mod.InputNode() as inp:
        a = scale.bind(inp, k=2)
        many = dag_mod.MultiOutputNode([a, sub.bind(a, 1), 7])
    with dag_mod.InputNode() as inp:
        whole = ident.bind(inp)
    refs = many.execute(3)
    return {
        "positional": pkg.get(pos.execute(10, 4)),
        "keyword": pkg.get(kw.execute(x=3, k=5)),
        "multi": [pkg.get(refs[0]), pkg.get(refs[1]), refs[2]],
        "whole_kwargs": sorted(pkg.get(whole.execute(p=1, q=2)).items()),
        "whole_tuple": list(pkg.get(whole.execute(1, 2))),
        "private_attr": raises(lambda: inp._hidden),
        "node_types": [type(n).__name__ for n in many._topo()],
    }


def test_input_attributes_and_multi_output():
    obs = _parity(_inputs_and_outputs)
    assert obs["positional"] == 6 and obs["keyword"] == 15
    assert obs["multi"] == [6, 5, 7]


def _actor_nodes(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    class Acc:
        def __init__(self, start):
            self.total = start

        def add(self, x):
            self.total += x
            return self.total

    live = Acc.remote(0)
    with dag_mod.InputNode() as inp:
        on_live = live.add.bind(inp)  # ActorMethodNode on a handle
    lazy = Acc.bind(1000)
    with dag_mod.InputNode() as inp:
        chained = lazy.add.bind(live.add.bind(inp))
    first = pkg.get(on_live.execute(5))
    second = pkg.get(chained.execute(2))
    return {
        "first": first, "second": second,
        "live_total": pkg.get(live.add.remote(0)),
        "lazy_total": pkg.get(lazy._get_or_create_handle().add.remote(0)),
        "types": [type(on_live).__name__, type(lazy).__name__,
                  type(lazy.add).__name__],
        "lazy_private": raises(lambda: lazy._nope),
    }


def test_actor_method_and_class_nodes():
    obs = _parity(_actor_nodes)
    assert obs["first"] == 5 and obs["second"] == 1007
    assert obs["types"] == ["ClassMethodNode", "ClassNode", "_UnboundMethod"]


# ---------------------------------------------- tests/test_dag.py:28 to :70
def _channel_roundtrip(pkg):
    dag_mod = _dag(pkg)
    ch = dag_mod.Channel(maxsize=2)
    ch.write(1)
    ch.write(2)
    got = [ch.read(), ch.read()]
    ch.close()
    return got, raises(ch.read), raises(lambda: ch.write(3)), \
        raises(lambda: dag_mod.Channel(maxsize=1).read(timeout=0.01))


def _slot_ring(pkg):
    ch = _dag(pkg).Channel(maxsize=8, slot_width=4)
    warm = [ch.acquire_slot() for _ in range(8)]
    widths = [len(s) for s in warm]
    grown = ch.slot_allocations
    for s in warm:
        s[0] = "payload"
        ch.release_slot(s)
    cleared = True
    for _ in range(100):  # steady state: pure reuse
        s = ch.acquire_slot()
        cleared = cleared and s[0] is None  # release cleared the fields
        s[0] = "payload"
        ch.release_slot(s)
    return widths, grown, cleared, ch.slot_allocations


def _read_ready(pkg):
    ch = _dag(pkg).Channel(maxsize=4)
    first = ch.read_ready(8)
    for i in range(4):
        ch.write(i)
    out = []
    same = ch.read_ready(3, out=out) is out
    ch.close()
    # buffered items survive close; a drained closed channel is empty
    return first, same, out, ch.read_ready(8), ch.read_ready(8), ch.closed


def _device_channel(pkg):
    dag_mod = _dag(pkg)
    if pkg is ray_tpu:
        import jax

        dev = jax.devices()[3]
        x = jax.numpy.ones((4,))
        kind = lambda a: next(iter(a.devices())).platform  # noqa: E731
    else:
        dev = "cpu"
        x = torch.ones((4,))
        kind = lambda a: a.device.type  # noqa: E731
    ch = dag_mod.DeviceChannel(device=dev, maxsize=1)
    ch.write({"x": x, "y": 7})
    out = ch.read()
    return out["y"], np.asarray(out["x"]).tolist(), kind(out["x"])


# ---------------------------------------------------- tests/test_dag.py:304
def _shared_memory_channel(pkg):
    rt = importlib.import_module(pkg.__name__ + "._private.runtime")
    plasma = rt.get_runtime().store.plasma
    dag_mod = _dag(pkg)
    writer = dag_mod.SharedMemoryChannel(plasma, "test_shm_ch", maxsize=4)
    # The reader: same arena, a cursor of its own (as in another process).
    reader = dag_mod.SharedMemoryChannel(plasma, "test_shm_ch", maxsize=4)
    got = []

    def consume():
        for _ in range(8):
            got.append(reader.read(timeout=10)["i"])

    t = threading.Thread(target=consume)
    t.start()
    for i in range(8):  # more than maxsize: the writer waits on the reader
        writer.write({"i": i, "blob": b"x" * 1000}, timeout=10)
    t.join(timeout=10)
    writer.close()
    return got, raises(lambda: writer.write({"i": 9})), plasma.usage()[2]


def test_shared_memory_channel_matches_reference():
    got, closed, objs = _parity(_shared_memory_channel)
    assert (got, closed, objs) == (list(range(8)), "ChannelClosed", 1)


@pytest.mark.parametrize("case", [_channel_roundtrip, _slot_ring, _read_ready,
                                  _device_channel],
                         ids=lambda c: c.__name__.lstrip("_"))
def test_channels_match_reference(case):
    ref, port = case(ray_tpu), case(ray_tpu_torch)
    assert ref == port


# --------------------------------------------- tests/test_dag.py:139 to :346
def _compiled_single_actor(pkg):
    @pkg.remote
    class Worker:
        def double(self, x):
            return 2 * x

    w = Worker.remote()
    with _dag(pkg).InputNode() as inp:
        dag = w.double.bind(inp)
    compiled = dag.experimental_compile()
    try:
        refs = [compiled.execute(i) for i in range(10)]
        return [r.get(timeout=10) for r in refs], type(compiled).__name__, \
            repr(refs[0])
    finally:
        compiled.teardown()


def _compiled_pipeline(pkg):
    @pkg.remote
    class Stage:
        def __init__(self, k):
            self.k = k

        def apply(self, x):
            return x + self.k

    s1, s2 = Stage.remote(1), Stage.remote(10)
    with _dag(pkg).InputNode() as inp:
        dag = s2.apply.bind(s1.apply.bind(inp))
    compiled = dag.experimental_compile()
    try:
        refs = [compiled.execute(i) for i in range(20)]
        return [r.get(timeout=10) for r in refs]
    finally:
        compiled.teardown()


def _compiled_multi_output(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    class W:
        def f(self, a, b):
            return a - b

        def g(self, a, k=1):
            return a * 3 * k

    w1, w2 = W.remote(), W.remote()
    with dag_mod.InputNode() as inp:
        dag = dag_mod.MultiOutputNode([w1.f.bind(inp[0], inp[1]),
                                       w2.g.bind(inp[0], k=inp.k)])
    compiled = dag.experimental_compile()
    try:
        ref = compiled.execute(9, 4, k=1)
        first = ref.get(timeout=10)
        again = raises(lambda: ref.get(timeout=10))  # a ref is got once
        return first, again, compiled.execute(2, 1, k=2).get(timeout=10)
    finally:
        compiled.teardown()


def _compiled_errors(pkg):
    @pkg.remote
    class W:
        def boom(self, x):
            if x < 0:
                raise ValueError("negative")
            return x

        def double(self, x):
            return 2 * x

    w1, w2 = W.remote(), W.remote()
    with _dag(pkg).InputNode() as inp:
        dag = w2.double.bind(w1.boom.bind(inp))
    compiled = dag.experimental_compile()
    try:
        ok = compiled.execute(3).get(timeout=10)
        try:
            compiled.execute(-1).get(timeout=10)
            err = None
        except ValueError as e:
            err = str(e)
        # The pipeline survives an error.
        return ok, err, compiled.execute(5).get(timeout=10)
    finally:
        compiled.teardown()


def _compiled_after_teardown(pkg):
    @pkg.remote
    class W:
        def f(self, x):
            return x + 1

    w = W.remote()
    with _dag(pkg).InputNode() as inp:
        compiled = w.f.bind(inp).experimental_compile()
    first = compiled.execute(1).get(timeout=10)
    compiled.teardown()
    compiled.teardown()  # idempotent
    # The resident loop released the actor's mailbox thread.
    return (first, pkg.get(w.f.remote(41), timeout=10),
            raises(lambda: compiled.execute(1)))


def _compiled_tensor_transport(pkg):
    if pkg is ray_tpu:
        import jax

        dev = jax.devices()[5]
        make = lambda n: jax.numpy.arange(n, dtype=jax.numpy.float32)  # noqa
        kinds = lambda x: [d.platform for d in x.devices()]  # noqa: E731
    else:
        dev = "cpu"
        make = lambda n: torch.arange(n, dtype=torch.float32)  # noqa: E731
        kinds = lambda x: [x.device.type]  # noqa: E731

    @pkg.remote
    class Producer:
        def make(self, n):
            return {"t": make(n), "n": n}

    @pkg.remote
    class Consumer:
        def where(self, x):
            return float(x["t"].sum()), kinds(x["t"]), x["n"]

    p, c = Producer.remote(), Consumer.remote()
    with _dag(pkg).InputNode() as inp:
        dag = c.where.bind(p.make.bind(inp).with_tensor_transport(device=dev))
    compiled = dag.experimental_compile()
    try:
        return [compiled.execute(n).get(timeout=10) for n in (4, 5)]
    finally:
        compiled.teardown()


def _compiled_allreduce(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    class Shard:
        def __init__(self, val):
            self.val = val

        def grad(self, x):
            return np.full((4,), self.val + x, np.float32)

        def norm(self, g):
            return float(np.linalg.norm(g))

    shards = [Shard.remote(i) for i in range(4)]
    with dag_mod.InputNode() as inp:
        grads = [s.grad.bind(inp) for s in shards]
        reduced = dag_mod.allreduce.bind(grads)
        dag = dag_mod.MultiOutputNode(
            [s.norm.bind(r) for s, r in zip(shards, reduced)])
    compiled = dag.experimental_compile()
    try:
        # sum over shards of (i + x) = 6 + 4x in each slot; norm = 2 * that
        out = [compiled.execute(x).get(timeout=10) for x in (1, 2)]
    finally:
        compiled.teardown()
    return out, raises(lambda: dag_mod.allreduce.bind([])), \
        raises(lambda: dag_mod.allreduce.bind([1]))


def _compiled_rejects_functions(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    def f(x):
        return x

    @pkg.remote
    class A:
        def m(self, x):
            return x

    with dag_mod.InputNode() as inp:
        fn_dag = f.bind(inp)
    with dag_mod.InputNode() as inp:
        const_out = dag_mod.MultiOutputNode([A.remote().m.bind(inp), 3])
    out = []
    for node in (fn_dag, const_out):
        try:
            node.experimental_compile()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _compiled_inflight_cap(pkg):
    @pkg.remote
    class W:
        def f(self, x):
            return x

    w = W.remote()
    with _dag(pkg).InputNode() as inp:
        compiled = w.f.bind(inp).experimental_compile(max_buffered=4)
    sent = 0
    try:
        for i in range(200):  # never consume: must raise, not hang
            compiled.execute(i)
            sent += 1
        err = None
    except ValueError as e:
        err = str(e)
    finally:
        compiled.teardown()
    return sent, err


def _compiled_timeout_no_desync(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    class Fast:
        def f(self, x):
            return ("fast", x)

    @pkg.remote
    class Slow:
        def f(self, x):
            time.sleep(0.5)
            return ("slow", x)

    fast, slow = Fast.remote(), Slow.remote()
    with dag_mod.InputNode() as inp:
        dag = dag_mod.MultiOutputNode([fast.f.bind(inp), slow.f.bind(inp)])
    compiled = dag.experimental_compile()
    try:
        ref0 = compiled.execute(0)
        # fast branch already read, slow times out
        timed_out = raises(lambda: ref0.get(timeout=0.05))
        # Retry after timeout must return the CORRECT, aligned row.
        return (timed_out, ref0.get(timeout=10),
                compiled.execute(1).get(timeout=10))
    finally:
        compiled.teardown()


# ------------------------------------------------ tests/test_dag.py:379-446
def _compiled_across_process_actors(pkg):
    @pkg.remote
    class Stage:
        def __init__(self, add):
            self.add = add

        def apply(self, x):
            return {"v": x["v"] + self.add, "pid": os.getpid()}

    a = Stage.options(isolation="process").remote(1)
    b = Stage.options(isolation="process").remote(10)
    with _dag(pkg).InputNode() as inp:
        out = b.apply.bind(a.apply.bind(inp))
    dag = out.experimental_compile()
    try:
        res = [dag.execute({"v": i, "pid": 0}).get(timeout=60)
               for i in range(5)]
    finally:
        dag.teardown()
    return ([r["v"] for r in res],
            all(r["pid"] != os.getpid() for r in res))


def _compiled_mixed_tiers(pkg):
    @pkg.remote
    class T:
        def f(self, x):
            return x * 2

    @pkg.remote
    class P:
        def g(self, x):
            return x + 100, os.getpid()

    t = T.remote()
    p = P.options(isolation="process").remote()
    with _dag(pkg).InputNode() as inp:
        out = p.g.bind(t.f.bind(inp))
    dag = out.experimental_compile()
    try:
        res = [dag.execute(i).get(timeout=60) for i in range(3)]
    finally:
        dag.teardown()
    return [v for v, _ in res], all(pid != os.getpid() for _, pid in res)


def _compiled_process_actor_error(pkg):
    @pkg.remote
    class Bad:
        def f(self, x):
            if x == 2:
                raise ValueError("proc stage exploded")
            return x

    b = Bad.options(isolation="process").remote()
    with _dag(pkg).InputNode() as inp:
        out = b.f.bind(inp)
    dag = out.experimental_compile()
    try:
        first = dag.execute(1).get(timeout=60)
        try:
            dag.execute(2).get(timeout=60)
            err = None
        except ValueError as e:
            err = ("ValueError", str(e))
        return first, err, dag.execute(3).get(timeout=60)
    finally:
        dag.teardown()


PROCESS = [_compiled_across_process_actors, _compiled_mixed_tiers,
           _compiled_process_actor_error]


@pytest.mark.parametrize("case", PROCESS, ids=lambda c: c.__name__.lstrip("_"))
def test_compiled_dag_over_process_actors_matches_reference(case):
    port = _parity(case)
    assert port == {
        "_compiled_across_process_actors": [[i + 11 for i in range(5)], True],
        "_compiled_mixed_tiers": [[100, 102, 104], True],
        "_compiled_process_actor_error": [1, ["ValueError",
                                              "proc stage exploded"], 3],
    }[case.__name__]


COMPILED = [_compiled_single_actor, _compiled_pipeline, _compiled_multi_output,
            _compiled_errors, _compiled_after_teardown,
            _compiled_tensor_transport, _compiled_allreduce,
            _compiled_rejects_functions, _compiled_inflight_cap,
            _compiled_timeout_no_desync]


@pytest.mark.parametrize("case", COMPILED,
                         ids=lambda c: c.__name__.lstrip("_"))
def test_compiled_dag_matches_reference(case):
    _parity(case)


def test_compiled_results_as_the_reference_states_them():
    """The reference test's own expectations, held on the port."""
    fresh_init(ray_tpu_torch, **INIT)
    try:
        assert _compiled_single_actor(ray_tpu_torch)[0] == [
            2 * i for i in range(10)]
        assert _compiled_pipeline(ray_tpu_torch) == [i + 11 for i in range(20)]
        assert _compiled_multi_output(ray_tpu_torch)[0] == [5, 27]
        assert _compiled_errors(ray_tpu_torch) == (6, "negative", 10)
        assert _compiled_after_teardown(ray_tpu_torch)[:2] == (2, 42)
        assert _compiled_allreduce(ray_tpu_torch)[0] == [
            [pytest.approx(20.0)] * 4, [pytest.approx(28.0)] * 4]
        sent, err = _compiled_inflight_cap(ray_tpu_torch)
        assert sent == 8 and "in flight" in err
        assert _compiled_timeout_no_desync(ray_tpu_torch) == (
            "ChannelTimeout", [("fast", 0), ("slow", 0)],
            [("fast", 1), ("slow", 1)])
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------------------ the port's own
@pytest.fixture
def port_rt():
    runtime = fresh_init(ray_tpu_torch, **INIT)
    yield runtime
    ray_tpu_torch.shutdown()


def _dag_threads():
    return [t.name for t in threading.enumerate()
            if "compiled_dag" in t.name or "dag" in t.name.split("-")[0]]


def test_shared_memory_channel_takes_writers_from_several_threads(port_rt):
    """Eight threads of one process write 50 elements each into one
    ``SharedMemoryChannel`` (a serve lane's callers do): the reader gets
    all 400, each once. Unlocked, two writers racing on the sequence number
    left a hole the reader waited on forever (the reference's channel has
    no lock)."""
    dag_mod = _dag(ray_tpu_torch)
    plasma = port_rt.store.plasma
    writer = dag_mod.SharedMemoryChannel(plasma, "threads_ch", maxsize=16)
    reader = dag_mod.SharedMemoryChannel(plasma, "threads_ch", maxsize=16)

    def produce(k):
        for i in range(50):
            writer.write((k, i), timeout=30)

    threads = [threading.Thread(target=produce, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    got = [tuple(reader.read(timeout=30)) for _ in range(400)]
    for t in threads:
        t.join(timeout=30)
    assert sorted(got) == [(k, i) for k in range(8) for i in range(50)]
    for k in range(8):  # each writer's own elements stay in its order
        assert [i for kk, i in got if kk == k] == list(range(50))


def test_tensor_transport_on_a_process_edge_raises(port_rt):
    """A DeviceChannel lives in one process: ``with_tensor_transport`` on an
    edge with a process actor at either end (into it, out of it, or out to
    the driver) raises a ValueError that says why, before any loop starts;
    both actors then answer plain calls."""
    dag_mod = _dag(ray_tpu_torch)

    @ray_tpu_torch.remote
    class T:
        def f(self, x):
            return x * 2

    t = T.remote()
    p = T.options(isolation="process").remote()
    dags = []
    with dag_mod.InputNode() as inp:
        dags.append(p.f.bind(t.f.bind(inp).with_tensor_transport("cpu")))
    with dag_mod.InputNode() as inp:
        dags.append(t.f.bind(p.f.bind(inp).with_tensor_transport("cpu")))
    with dag_mod.InputNode() as inp:
        dags.append(p.f.bind(inp).with_tensor_transport("cpu"))
    for dag in dags:
        with pytest.raises(ValueError, match="shared-memory channel"):
            dag.experimental_compile()
    assert ray_tpu_torch.get(t.f.remote(2), timeout=30) == 4
    assert ray_tpu_torch.get(p.f.remote(3), timeout=60) == 6


def test_teardown_leaves_no_channel_element_in_the_arena(port_rt):
    """Elements written and never read, and the close sentinels, are
    reclaimed once the process loops have ended: the arena holds what it
    held before the DAG."""
    dag_mod = _dag(ray_tpu_torch)
    plasma = port_rt.store.plasma

    @ray_tpu_torch.remote
    class W:
        def f(self, x):
            return x + 1

    a, b = (W.options(isolation="process").remote() for _ in range(2))
    ray_tpu_torch.get([a.f.remote(0), b.f.remote(0)], timeout=60)
    before = plasma.usage()
    with dag_mod.InputNode() as inp:
        dag = b.f.bind(a.f.bind(inp))
    compiled = dag.experimental_compile(max_buffered=4)
    assert compiled.execute(1).get(timeout=60) == 3
    for i in range(3):  # left unread in the output edge
        compiled.execute(i)
    time.sleep(0.5)
    assert plasma.usage()[2] > before[2]
    compiled.teardown()
    assert plasma.usage() == before
    assert not any(t.is_alive() for t in compiled._loop_threads)
    assert ray_tpu_torch.get(a.f.remote(5), timeout=30) == 6


def test_cpu_tensor_leaf_stays_on_the_cpu_across_a_process_edge(port_rt):
    """A CPU tensor crosses a process edge as torch pickles it and stays a
    CPU tensor, both ways; no transfer is ledgered and the ``dag_channel``
    pool stays balanced."""
    from ray_tpu_torch.util import device_telemetry as dt

    dt.reset()
    dag_mod = _dag(ray_tpu_torch)

    @ray_tpu_torch.remote
    class P:
        def f(self, x):
            return {"device": x["t"].device.type, "t": x["t"] * 2,
                    "rest": x["rest"]}

    p = P.options(isolation="process").remote()
    with dag_mod.InputNode() as inp:
        dag = p.f.bind(inp)
    compiled = dag.experimental_compile()
    try:
        x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
        out = compiled.execute({"t": x, "rest": [1, "a"]}).get(timeout=60)
    finally:
        compiled.teardown()
    assert out["device"] == "cpu" and out["t"].device.type == "cpu"
    assert torch.equal(out["t"], x * 2) and out["rest"] == [1, "a"]
    assert [r for r in dt.transfer_records()
            if r["src"] == "dag_channel"] == []
    assert dt.pool_bytes().get("dag_channel", {}).get("bytes", 0) == 0


def test_tensor_transport_without_a_device():
    """``with_tensor_transport()`` means the current CUDA device: on a host
    without one it raises at the call; with one it pins that device."""
    node = _dag(ray_tpu_torch).ClassMethodNode(None, "m", (), {})
    if torch.cuda.is_available():
        node.with_tensor_transport()
        assert node._tensor_transport == torch.device(
            "cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            node.with_tensor_transport()
        assert node._tensor_transport is None
    assert node.with_tensor_transport("cpu") is node
    assert node._tensor_transport == torch.device("cpu")


def test_dag_channel_pool_balances_and_records_no_transfer(port_rt):
    """Each element's tensor bytes sit in the ``dag_channel`` pool from
    write to read; a tensor already on the channel's device is handed over
    as is (same storage), and no transfer is ledgered for it."""
    from ray_tpu_torch.util import device_telemetry as dt

    dt.reset()
    dag_mod = _dag(ray_tpu_torch)
    ch = dag_mod.DeviceChannel(device="cpu", maxsize=4)
    a, b = torch.ones(8), torch.zeros((2, 3), dtype=torch.float64)
    ch.write({"a": a, "rest": [b, 3, (a, "x")]})
    assert dt.pool_bytes()["dag_channel"]["bytes"] == 32 + 48 + 32
    out = ch.read()
    assert out["a"] is a and out["rest"][0] is b and out["rest"][2][0] is a
    assert out["rest"][1:] == [3, (a, "x")]
    assert dt.pool_bytes()["dag_channel"]["bytes"] == 0
    ch.write(torch.ones(4))
    ch.write(torch.ones(2))
    assert ch.read_ready(8)[1].shape == (2,)
    assert dt.pool_bytes()["dag_channel"] == {"bytes": 0.0, "peak": 112.0}

    @ray_tpu_torch.remote
    class P:
        def make(self, n):
            return torch.arange(n, dtype=torch.float32)

    @ray_tpu_torch.remote
    class C:
        def total(self, x):
            return float(x.sum())

    p, c = P.remote(), C.remote()
    with dag_mod.InputNode() as inp:
        dag = c.total.bind(p.make.bind(inp).with_tensor_transport("cpu"))
    compiled = dag.experimental_compile()
    try:
        assert [compiled.execute(n).get(timeout=10)
                for n in (4, 8, 16)] == [6.0, 28.0, 120.0]
        # Unread elements are released at teardown.
        compiled.execute(32)
        time.sleep(0.2)
    finally:
        compiled.teardown()
    assert dt.pool_bytes()["dag_channel"]["bytes"] == 0
    assert [r for r in dt.transfer_records() if r["src"] == "dag_channel"] \
        == []


def test_teardown_leaves_no_loop_and_frees_the_actors(port_rt):
    dag_mod = _dag(ray_tpu_torch)

    @ray_tpu_torch.remote
    class W:
        def f(self, x):
            return x + 1

    ws = [W.remote() for _ in range(3)]
    with dag_mod.InputNode() as inp:
        dag = ws[2].f.bind(ws[1].f.bind(ws[0].f.bind(inp)))
    before = set(threading.enumerate())
    compiled = dag.experimental_compile(max_buffered=2)
    assert compiled.execute(0).get(timeout=10) == 3
    compiled.teardown()
    runtime = ray_tpu_torch._private.runtime.get_runtime()
    # Every resident loop, an actor task, returned.
    assert [runtime.get(r, timeout=5) for r in compiled._loop_refs] == [
        None] * 3
    for w in ws:
        assert ray_tpu_torch.get(w.f.remote(1), timeout=10) == 2
        inst = runtime.get_actor_state(w._ray_actor_id).instance
        assert not [a for a in vars(inst) if a.startswith("__ray_tpu_dag")]
    # The loops ran on the actors' own threads: the DAG started none (an
    # actor's thread may start late, the runtime's task pool may grow).
    assert [t.name for t in threading.enumerate() if t not in before
            and not t.name.startswith("ray_tpu_torch_worker")
            and "_actor_sync_loop" not in t.name] == []


# ------------------------------------------------------- the slice, entire
def test_gpt2_split_over_two_compiled_actors():
    """GPT-2 tiny's forward split over two thread actors (layer 0, then
    layer 1 with the final layernorm and head) and compiled: its logits
    equal the port's whole forward bit for bit, and the JAX package's
    forward from the same weights within tests/test_torch_gpt2.py's
    tolerance (1e-4)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.serve.gpt2 import GPT2Stage

    fields = dict(vocab_size=256, n_layer=2, n_head=2, d_model=128,
                  seq_len=128, attn_block_q=128, attn_block_kv=128,
                  remat=False, attn_impl="auto")
    jcfg = jgpt2.GPTConfig(dtype=jnp.float32, logits_dtype=jnp.float32,
                           **fields)
    tcfg = tgpt2.GPTConfig(dtype=torch.float32, logits_dtype=torch.float32,
                           **fields)
    jparams = jax.tree.map(np.asarray,
                           jgpt2.init_params(jcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 128)).astype(
        np.int32)
    expected = np.asarray(jax.jit(lambda p, t: jgpt2.forward(p, t, jcfg))(
        jparams, jnp.asarray(tokens)), np.float32)
    params = convert.params_from_numpy(jparams, device="cpu")
    with torch.inference_mode():
        whole = tgpt2.forward(tgpt2.inference_params(params, tcfg),
                              torch.as_tensor(tokens, dtype=torch.long), tcfg)

    fresh_init(ray_tpu_torch, **INIT)
    try:
        Stage = ray_tpu_torch.remote(GPT2Stage)
        a = Stage.remote((0, 1), tcfg, device="cpu", params=params)
        b = Stage.remote((1, 2), tcfg, device="cpu", params=params)
        dag_mod = _dag(ray_tpu_torch)
        with dag_mod.InputNode() as inp:
            dag = b.tail.bind(a.head.bind(inp).with_tensor_transport("cpu"))
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(tokens[i:i + 1]) for i in range(2)]
            refs.append(compiled.execute(tokens))
            outs = [r.get(timeout=60) for r in refs]
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
    split = torch.cat(outs[:2])
    assert outs[2].dtype == torch.float32 and outs[2].shape == (2, 128, 256)
    assert torch.equal(outs[2], whole)
    assert torch.equal(split, whole)
    np.testing.assert_allclose(outs[2].numpy(), expected, rtol=1e-4,
                               atol=1e-4)


def test_gpt2_split_over_two_compiled_process_actors():
    """GPT-2 tiny's forward split over two PROCESS actors (layer 0, then
    layer 1 with the final layernorm and head), compiled over shared-memory
    edges on the CPU: its logits equal the port's whole forward bit for bit,
    and the JAX package's forward from the same weights within
    tests/test_torch_gpt2.py's tolerance (1e-4)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.serve.gpt2 import GPT2Stage

    fields = dict(vocab_size=256, n_layer=2, n_head=2, d_model=128,
                  seq_len=128, attn_block_q=128, attn_block_kv=128,
                  remat=False, attn_impl="auto")
    jcfg = jgpt2.GPTConfig(dtype=jnp.float32, logits_dtype=jnp.float32,
                           **fields)
    tcfg = tgpt2.GPTConfig(dtype=torch.float32, logits_dtype=torch.float32,
                           **fields)
    jparams = jax.tree.map(np.asarray,
                           jgpt2.init_params(jcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 128)).astype(
        np.int32)
    expected = np.asarray(jax.jit(lambda p, t: jgpt2.forward(p, t, jcfg))(
        jparams, jnp.asarray(tokens)), np.float32)
    params = convert.params_from_numpy(jparams, device="cpu")
    with torch.inference_mode():
        whole = tgpt2.forward(tgpt2.inference_params(params, tcfg),
                              torch.as_tensor(tokens, dtype=torch.long), tcfg)

    fresh_init(ray_tpu_torch, **INIT)
    try:
        Stage = ray_tpu_torch.remote(GPT2Stage).options(isolation="process")
        a = Stage.remote((0, 1), tcfg, device="cpu", params=params)
        b = Stage.remote((1, 2), tcfg, device="cpu", params=params)
        dag_mod = _dag(ray_tpu_torch)
        with dag_mod.InputNode() as inp:
            dag = b.tail.bind(a.head.bind(inp))
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(tokens[i:i + 1]) for i in range(2)]
            refs.append(compiled.execute(tokens))
            outs = [r.get(timeout=120) for r in refs]
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
    split = torch.cat(outs[:2])
    assert outs[2].dtype == torch.float32 and outs[2].shape == (2, 128, 256)
    assert torch.equal(outs[2], whole)
    assert torch.equal(split, whole)
    np.testing.assert_allclose(outs[2].numpy(), expected, rtol=1e-4,
                               atol=1e-4)


def test_pp_inference_dag_example_at_the_tiny_size():
    from ray_tpu_torch.examples import pp_inference_dag

    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    out = pp_inference_dag.main(["--device", "cpu", "--tiny",
                                 "--requests", "8"])
    pa, pb = out["stage_pids"]
    assert len({pa, pb, os.getpid()}) == 3
    assert len(out["next_tokens"]) == 9
    with pytest.raises(NotImplementedError, match="13.8b"):
        pp_inference_dag.main(["--nodes"])


def test_edge_records_a_transfer_only_across_the_host():
    """The reference ledgers every DeviceChannel write as an h2d transfer,
    a placement from one host device to another included
    (ray_tpu/dag/channel.py:177); the port ledgers bytes only where they
    cross the host boundary, so a host-to-host edge records none. Both
    pools see the bytes while they wait and release them at the read."""
    import jax

    from ray_tpu.util import device_telemetry as rdt
    from ray_tpu_torch.util import device_telemetry as tdt

    rdt.reset()
    ref = _dag(ray_tpu).DeviceChannel(device=jax.devices()[3])
    ref.write({"x": jax.numpy.ones((4,), jax.numpy.float32)})
    ref_pool = rdt.pool_bytes()["dag_channel"]["bytes"]
    ref.read()
    tdt.reset()
    port = _dag(ray_tpu_torch).DeviceChannel(device="cpu")
    port.write({"x": torch.ones((4,), dtype=torch.float32)})
    port_pool = tdt.pool_bytes()["dag_channel"]["bytes"]
    port.read()
    assert ref_pool == port_pool == 16
    assert rdt.pool_bytes()["dag_channel"]["bytes"] == 0
    assert tdt.pool_bytes()["dag_channel"]["bytes"] == 0
    assert [(r["direction"], r["bytes"]) for r in rdt.transfer_records()
            if r["src"] == "dag_channel"] == [("h2d", 16)]
    assert [r for r in tdt.transfer_records()
            if r["src"] == "dag_channel"] == []
