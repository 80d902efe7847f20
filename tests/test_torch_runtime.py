"""The port's thread-tier runtime (ray_tpu_torch) against the reference
(ray_tpu) on the cases of tests/test_core_actors.py and the
generator/get/put/wait/kill cases of tests/test_core_tasks.py.

Each case is one body run against both packages, one after the other (the
two runtimes never run at once): it returns what it observed, and the
port's observation must equal the reference's. Errors are observed by
class name, which the two packages share.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init, gc_paused


class _Counter:
    def __init__(self, start=0):
        self.value = start

    def inc(self, delta=1):
        self.value += delta
        return self.value

    def get(self):
        return self.value


def _raises(fn):
    """The class name of what ``fn`` raises (None if it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return type(e).__name__
    return None


# ------------------------------------------------------------------ actors
def actor_basic(pkg):
    c = pkg.remote(_Counter).remote()
    return [pkg.get(c.inc.remote()), pkg.get(c.inc.remote(5)),
            pkg.get(c.get.remote())]


def actor_ordering(pkg):
    c = pkg.remote(_Counter).remote()
    refs = [c.inc.remote() for _ in range(50)]
    return [pkg.get(refs[-1]), pkg.get(refs)]


def actor_init_args(pkg):
    c = pkg.remote(_Counter).remote(start=100)
    return pkg.get(c.get.remote())


def actor_method_error_does_not_kill(pkg):
    class Fragile:
        def fail(self):
            raise RuntimeError("method error")

        def ok(self):
            return "ok"

    a = pkg.remote(Fragile).remote()
    return [_raises(lambda: pkg.get(a.fail.remote())), pkg.get(a.ok.remote())]


def named_actor(pkg):
    pkg.remote(_Counter).options(name="global_counter").remote(start=7)
    handle = pkg.get_actor("global_counter")
    return [pkg.get(handle.get.remote()),
            _raises(lambda: pkg.get_actor("no_such_actor"))]


def kill_actor(pkg):
    a = pkg.remote(_Counter).remote()
    first = pkg.get(a.inc.remote())
    pkg.kill(a)
    time.sleep(0.2)
    return [first, _raises(lambda: pkg.get(a.inc.remote(), timeout=5))]


def actor_init_failure(pkg):
    class Bad:
        def __init__(self):
            raise ValueError("init fails")

        def m(self):
            return 1

    a = pkg.remote(Bad).remote()
    return _raises(lambda: pkg.get(a.m.remote(), timeout=10))


def handle_passing(pkg):
    c = pkg.remote(_Counter).remote()

    def use_counter(handle):
        return pkg.get(handle.inc.remote(10))

    return [pkg.get(pkg.remote(use_counter).remote(c)),
            pkg.get(c.get.remote())]


def async_actor(pkg):
    class AsyncWorker:
        async def work(self, x):
            await asyncio.sleep(0.05)
            return x * 2

    a = pkg.remote(AsyncWorker).options(max_concurrency=8).remote()
    start = time.monotonic()
    out = pkg.get([a.work.remote(i) for i in range(8)])
    # 8 concurrent 50 ms sleeps take well under 8 * 50 ms.
    return [out, time.monotonic() - start < 0.4]


def threaded_actor_concurrency(pkg):
    class Sleeper:
        def nap(self):
            time.sleep(0.1)
            return 1

    a = pkg.remote(Sleeper).options(max_concurrency=4).remote()
    start = time.monotonic()
    out = pkg.get([a.nap.remote() for _ in range(4)])
    return [out, time.monotonic() - start < 0.35]


def exit_actor(pkg):
    class Quitter:
        def quit(self):
            pkg.exit_actor()

        def m(self):
            return 1

    a = pkg.remote(Quitter).remote()
    pkg.get(a.quit.remote())
    return _raises(lambda: pkg.get(a.m.remote(), timeout=5))


def actor_restart(pkg):
    a = pkg.remote(_Counter).options(max_restarts=1).remote()
    pkg.get(a.inc.remote())
    pkg.kill(a, no_restart=False)
    time.sleep(0.3)
    # Restarted: state reset by re-running __init__.
    return pkg.get(a.get.remote(), timeout=10)


def actor_generator_method(pkg):
    class Gen:
        def stream(self, n):
            for i in range(n):
                yield i

    g = pkg.remote(Gen).remote()
    return pkg.get(list(g.stream.remote(3)))


# ------------------------------------------------------------------- tasks
def put_get(pkg):
    out = pkg.get(pkg.put({"a": 1, "b": np.arange(10)}))
    return [out["a"], out["b"].tolist()]


def simple_task(pkg):
    return pkg.get(pkg.remote(lambda a, b: a + b).remote(1, 2))


def task_with_ref_args(pkg):
    add = pkg.remote(lambda a, b: a + b)
    r1 = add.remote(pkg.put(10), 5)
    return pkg.get(add.remote(r1, r1))


def task_chain_dependencies(pkg):
    inc = pkg.remote(lambda x: x + 1)
    ref = pkg.put(0)
    for _ in range(20):
        ref = inc.remote(ref)
    return pkg.get(ref)


def multiple_returns(pkg):
    def three():
        return 1, 2, 3

    a, b, c = pkg.remote(num_returns=3)(three).remote()
    return pkg.get([a, b, c])


def task_error_propagates(pkg):
    def boom():
        raise ValueError("boom")

    try:
        pkg.get(pkg.remote(boom).remote())
    except pkg.exceptions.TaskError as e:
        return ["boom" in str(e), type(e.cause).__name__]
    return None


def error_propagates_through_chain(pkg):
    def boom():
        raise ValueError("inner")

    consume = pkg.remote(lambda x: x)
    return _raises(lambda: pkg.get(consume.remote(pkg.remote(boom).remote())))


def wait(pkg):
    def slow():
        time.sleep(2)
        return "slow"

    f, s = pkg.remote(lambda: "fast").remote(), pkg.remote(slow).remote()
    ready, pending = pkg.wait([f, s], num_returns=1, timeout=1.5)
    return [ready == [f], pending == [s], pkg.get(s)]


def get_timeout(pkg):
    def slow():
        time.sleep(1)

    return _raises(lambda: pkg.get(pkg.remote(slow).remote(), timeout=0.2))


def nested_tasks(pkg):
    inner = pkg.remote(lambda x: x * 2)
    outer = pkg.remote(lambda x: pkg.get(inner.remote(x)) + 1)
    return pkg.get(outer.remote(5))


def generator_task(pkg):
    def gen(n):
        for i in range(n):
            yield i * i

    return pkg.get(list(pkg.remote(gen).remote(4)))


def options_override(pkg):
    f = pkg.remote(num_cpus=2)(lambda: 1)
    return pkg.get(f.options(num_cpus=1).remote())


def cancel_pending(pkg):
    def blocker():
        time.sleep(2)

    blockers = [pkg.remote(blocker).remote() for _ in range(4)]
    ref = pkg.remote(num_cpus=4)(lambda: 1).remote()  # waits for the CPUs
    time.sleep(0.1)
    pkg.cancel(ref)
    out = _raises(lambda: pkg.get(ref, timeout=5))
    pkg.get(blockers)
    return out


def large_object_roundtrip(pkg):
    arr = np.random.default_rng(0).random((1000, 1000))
    return bool(np.array_equal(pkg.get(pkg.put(arr)), arr))


def infeasible_fails_fast(pkg):
    f = pkg.remote(num_cpus=1000)(lambda: 1)
    start = time.monotonic()
    out = _raises(lambda: pkg.get(f.remote(), timeout=10))
    return [out is not None, time.monotonic() - start < 5]


def cluster_resources(pkg):
    return pkg.cluster_resources()["CPU"]


CASES = [
    (actor_basic, [1, 6, 6]),
    (actor_ordering, [50, list(range(1, 51))]),
    (actor_init_args, 100),
    (actor_method_error_does_not_kill, ["TaskError", "ok"]),
    (named_actor, [7, "ValueError"]),
    (kill_actor, [1, "ActorDiedError"]),
    (actor_init_failure, "ActorDiedError"),
    (handle_passing, [10, 10]),
    (async_actor, [[i * 2 for i in range(8)], True]),
    (threaded_actor_concurrency, [[1, 1, 1, 1], True]),
    (exit_actor, "ActorDiedError"),
    (actor_restart, 0),
    (actor_generator_method, [0, 1, 2]),
    (put_get, [1, list(range(10))]),
    (simple_task, 3),
    (task_with_ref_args, 30),
    (task_chain_dependencies, 20),
    (multiple_returns, [1, 2, 3]),
    (task_error_propagates, [True, "ValueError"]),
    (error_propagates_through_chain, "TaskError"),
    (wait, [True, True, "slow"]),
    (get_timeout, "GetTimeoutError"),
    (nested_tasks, 11),
    (generator_task, [0, 1, 4, 9]),
    (options_override, 1),
    (cancel_pending, "TaskCancelledError"),
    (large_object_roundtrip, True),
    (infeasible_fails_fast, [True, True]),
    (cluster_resources, 4),
]


def _run(pkg, case):
    fresh_init(pkg, num_cpus=4)
    try:
        return case(pkg)
    finally:
        pkg.shutdown()


@pytest.mark.parametrize("case,expected", CASES,
                         ids=[c.__name__ for c, _ in CASES])
def test_port_runtime_matches_reference(case, expected):
    with gc_paused():
        ref = _run(ray_tpu, case)
    port = _run(ray_tpu_torch, case)
    assert ref == expected
    assert port == ref


# ----------------------------------------------------- the port's own rules
@pytest.fixture
def port():
    fresh_init(ray_tpu_torch, num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("kind", ["task", "actor"])
@pytest.mark.parametrize("option", [{"isolation": "process"},
                                    {"runtime_env": {"env_vars": {"A": "1"}}}])
def test_process_tier_runs_in_a_worker(port, kind, option):
    """Both options run the call in a spawned worker process, never on a
    thread: its pid is not the driver's, and its environment is the
    worker's (the runtime env's variable; with no GPU leased, no card)."""
    import os

    def probe():
        return (os.getpid(), os.environ.get("A"),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    class Probe:
        def probe(self):
            return probe()

    if kind == "task":
        ref = port.remote(probe).options(**option).remote()
    else:
        ref = port.remote(Probe).options(**option).remote().probe.remote()
    pid, a, visible = port.get(ref, timeout=60)
    assert pid != os.getpid()
    assert a == ("1" if "runtime_env" in option else None)
    assert visible == ""


def test_gpu_resource_follows_num_gpus():
    """A num_gpus=1 actor is infeasible where no GPU is registered (this
    host: torch counts none) and runs once init(num_gpus=1) registers one."""
    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
        a = ray_tpu_torch.remote(_Counter).options(num_gpus=1).remote()
        with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError):
            ray_tpu_torch.get(a.inc.remote(), timeout=10)
        state = ray_tpu_torch._private.runtime.get_runtime().get_actor_state(
            a._ray_actor_id)
        assert type(state.death_cause).__name__ == "InfeasibleError"
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1
        a = ray_tpu_torch.remote(_Counter).options(num_gpus=1).remote()
        assert ray_tpu_torch.get(a.inc.remote(), timeout=10) == 1
        assert ray_tpu_torch.available_resources()["GPU"] == 0
        # The one GPU is held: a second GPU task waits until the actor dies.
        ref = ray_tpu_torch.remote(num_gpus=1)(lambda: "ran").remote()
        assert ray_tpu_torch.wait([ref], timeout=0.3)[0] == []
        ray_tpu_torch.kill(a)
        assert ray_tpu_torch.get(ref, timeout=10) == "ran"
    finally:
        ray_tpu_torch.shutdown()


class _GpuHolder:
    def __init__(self):
        from ray_tpu_torch._private.device import granted_cuda_device

        self.ids = ray_tpu_torch.get_gpu_ids()
        self.device = str(granted_cuda_device())

    def get(self):
        return self.ids, self.device, ray_tpu_torch.get_gpu_ids()


def test_each_gpu_lease_names_its_own_card(monkeypatch):
    """On a host with two cards (torch's count faked here), two one-GPU
    actors are granted different indices and pin different devices; a third
    waits for a card and gets the one its predecessor freed."""
    monkeypatch.setattr(ray_tpu_torch._private.device, "gpu_count", lambda: 2)
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2
        holders = [ray_tpu_torch.remote(_GpuHolder).options(num_gpus=1).remote()
                   for _ in range(2)]
        got = ray_tpu_torch.get([h.get.remote() for h in holders], timeout=10)
        assert sorted(got) == [([0], "cuda:0", [0]), ([1], "cuda:1", [1])]
        third = ray_tpu_torch.remote(_GpuHolder).options(num_gpus=1).remote()
        ref = third.get.remote()
        assert ray_tpu_torch.wait([ref], timeout=0.3)[0] == []
        ray_tpu_torch.kill(holders[1])
        assert ray_tpu_torch.get(ref, timeout=10) == got[1]
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_fractions_share_an_index(monkeypatch):
    """Two half-GPU actors share index 0; a whole GPU then gets index 1,
    and a task's own ids are what get_gpu_ids reads inside it."""
    monkeypatch.setattr(ray_tpu_torch._private.device, "gpu_count", lambda: 2)
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        halves = [ray_tpu_torch.remote(_GpuHolder).options(num_gpus=0.5).remote()
                  for _ in range(2)]
        got = ray_tpu_torch.get([h.get.remote() for h in halves], timeout=10)
        assert got == [([0], "cuda:0", [0])] * 2
        whole = ray_tpu_torch.remote(num_gpus=1)(ray_tpu_torch.get_gpu_ids)
        assert ray_tpu_torch.get(whole.remote(), timeout=10) == [1]
        assert ray_tpu_torch.get_gpu_ids() == []  # the driver holds none
    finally:
        ray_tpu_torch.shutdown()


def test_task_blocked_in_get_lends_its_cpu_and_keeps_its_gpu():
    """The one CPU goes to the inner task while the outer one waits for
    it (else this deadlocks); the outer keeps its GPU all the while."""
    fresh_init(ray_tpu_torch, num_cpus=1, num_gpus=1)
    try:
        inner = ray_tpu_torch.remote(num_cpus=1)(
            lambda: ray_tpu_torch.available_resources()["GPU"])

        @ray_tpu_torch.remote(num_cpus=1, num_gpus=1)
        def outer():
            return ray_tpu_torch.get(inner.remote()), ray_tpu_torch.get_gpu_ids()

        assert ray_tpu_torch.get(outer.remote(), timeout=10) == (0.0, [0])
        # The lease goes back, whole, just after the result is stored.
        deadline = time.monotonic() + 10
        while ray_tpu_torch.available_resources() != ray_tpu_torch.cluster_resources() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ray_tpu_torch.available_resources() == ray_tpu_torch.cluster_resources()
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_counts_above_one_are_whole(port):
    with pytest.raises(ValueError, match="whole"):
        port.remote(lambda: 1).options(num_gpus=1.5).remote()
    port.shutdown()
    table = ray_tpu_torch._private.object_ref.global_refcounter()
    before = table._zero_callback
    with pytest.raises(ValueError, match="whole"):
        port.init(num_gpus=1.5)
    # The refused init left no runtime, and handed the refcount table no
    # half-built runtime's free.
    assert not port.is_initialized()
    assert table._zero_callback == before


def test_scheduling_strategy_is_accepted_on_one_node(port):
    """The option chooses among nodes: on the one node it changes nothing."""
    f = port.remote(lambda: "ran").options(scheduling_strategy="SPREAD")
    assert port.get(f.remote(), timeout=10) == "ran"


def test_put_holds_the_value_itself(port):
    """The thread tier stores a reference, never a copy: a tensor put and
    got back is the same object."""
    import torch

    t = torch.arange(4)
    assert port.get(port.put(t)) is t


def test_init_twice_and_address(port):
    with pytest.raises(RuntimeError, match="twice"):
        port.init()
    assert port.init(ignore_reinit_error=True) is not None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ray_tpu_torch.init(address="ray://localhost:1")


def test_freed_object_leaves_the_store(port):
    from ray_tpu_torch._private.runtime import get_runtime

    ref = port.put(np.zeros(10))
    oid = ref.id
    assert get_runtime().store.contains(oid)
    del ref
    assert not get_runtime().store.contains(oid)


@pytest.mark.parametrize("kind", ["task", "actor"])
def test_generator_items_outlive_its_failure(port, kind):
    """tests/test_process_tier.py:246 on the thread tier, where the
    generator runs to its error before the consumer reads: the item it
    yielded first stays readable, and the next one raises the error."""

    def bad():
        yield 1
        raise RuntimeError("stream blew up")

    class Gen:
        def bad(self):
            yield from bad()

    if kind == "task":
        gen = port.remote(bad).remote()
    else:
        gen = port.remote(Gen).remote().bad.remote()
    it = iter(gen)
    first = next(it)
    time.sleep(0.1)  # the generator has failed by now
    assert port.get(first) == 1
    with pytest.raises(port.exceptions.TaskError, match="stream blew up"):
        port.get(next(it))


def test_a_release_inside_the_refcount_lock_is_deferred(port):
    """The collector can run a handle's finalizer inside the refcount
    table's own critical section on the same thread: the release must not
    wait for the lock (it would wait for itself) but be applied by the next
    call that takes it."""
    from ray_tpu_torch._private.object_ref import global_refcounter
    from ray_tpu_torch._private.runtime import get_runtime

    counter, store = global_refcounter(), get_runtime().store
    ref = port.put("x")
    oid = ref.id
    done = threading.Event()

    def release_while_locked():
        with counter._lock:  # as if the collector ran the finalizer here
            nonlocal ref
            del ref
        done.set()

    t = threading.Thread(target=release_while_locked, daemon=True)
    t.start()
    assert done.wait(10), "the finalizer waited for its own lock"
    assert store.contains(oid)  # deferred
    port.put("y")  # the next add applies it
    assert not store.contains(oid)
