"""The port's DAGs (``ray_tpu_torch.dag``) against the reference's: the
channels of tests/test_dag.py (:28, :39, :57, :70), its interpreted cases
(:84, :98, :120) and more of the node kinds, and its compiled graphs over
thread actors (:139 to :293, :329, :346) on both packages. The reference's
shared-memory channel and process-actor edges (:304, :379-446) wait for
ROADMAP.md Queue 1 item 11b-2; the port refuses a process actor's edge and
says so. Then the port's own: ``with_tensor_transport`` without a device,
the ``dag_channel`` pool and transfer ledger, and GPT-2 tiny split over two
thread actors and compiled, against the port's whole forward and the JAX
package's.

Each parity case runs on the reference, then on the port, each in a runtime
of its own (tests/_torch_train_parity.py); the observations must be equal.
Where the reference places a jax array on a CPU device, the port's
``DeviceChannel`` places a tensor on ``device="cpu"``: the values and the
device's kind are compared.
"""

import importlib
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


def test_process_actor_edge_names_item_11b2(port_rt):
    """The reference gives a process actor's edges the arena's channels
    (tests/test_dag.py:379); the port has none yet and refuses the DAG."""
    dag_mod = _dag(ray_tpu_torch)

    @ray_tpu_torch.remote
    class T:
        def f(self, x):
            return x * 2

    t = T.remote()
    p = T.options(isolation="process").remote()
    with dag_mod.InputNode() as inp:
        mixed = p.f.bind(t.f.bind(inp))
    with dag_mod.InputNode() as inp:
        alone = p.f.bind(inp)
    for dag in (mixed, alone):
        with pytest.raises(ValueError, match="item 11b-2"):
            dag.experimental_compile()
    # Refused before any loop started: both actors answer plain calls.
    assert ray_tpu_torch.get(t.f.remote(2), timeout=30) == 4
    assert ray_tpu_torch.get(p.f.remote(3), timeout=60) == 6
    assert ray_tpu_torch.get(mixed.execute(5), timeout=60) == 20


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
