"""The port's compiled steady-state serve route
(``ray_tpu_torch/serve/compiled_router.py``) against the reference's, on
the cases of tests/test_serve_compiled.py: lowering after the stability
window, batch fusion, parity with the dynamic path (results, methods,
errors, composition, multiplexing), teardown and recompilation on a
membership change, the two switches (``RAY_TPU_SERVE_COMPILED=0`` and
``compiled_route=False``), ``serve.status()``'s route mode, shedding, and
the slot ring's steady state.

Each case is one body run on ``ray_tpu`` and then on ``ray_tpu_torch``,
each on a fresh runtime and serve instance with a 0.2 s stability window,
the reference's half under ``gc_paused`` (tests/_torch_runtimes.py says
why); the observations must be equal. tests/test_serve_compiled.py:193
(a process-tier replica lowered onto lanes over the shared-memory arena)
runs the reference's half in a child interpreter (tests/_torch_child.py).

The port's own: the lanes' threads end with serve, and 20 rounds of a
shutdown under compiled load on a process replica crash nothing and leave
no lane thread, arena or worker behind.
"""

import asyncio
import importlib
import os
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve
from _torch_child import as_json, in_child
from _torch_runtimes import fresh_init, gc_paused


def _serve(pkg):
    return importlib.import_module(pkg.__name__ + ".serve")


def _router_mod(pkg):
    return importlib.import_module(pkg.__name__ + ".serve.compiled_router")


def _wait_compiled(handle, timeout=8.0):
    router = handle._get_router()
    deadline = time.time() + timeout
    while router._compiled.mode != "compiled":
        if time.time() > deadline:
            raise AssertionError("route never compiled")
        time.sleep(0.02)
    return router


def _error(fn):
    """(class name, class name of its cause) of what ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        cause = getattr(e, "cause", None)
        return type(e).__name__, type(cause).__name__ if cause else None
    return None


# ------------------------------------------- tests/test_serve_compiled.py:38
def compiles_after_stability_window(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=2, max_ongoing_requests=16)
    class Echo:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.002)
        async def __call__(self, items):
            return [x * 2 for x in items]

    h = serve.run(Echo.bind(), name="app", route_prefix=None)
    # First request lands before the window: dynamic path.
    first = h.remote(3).result(timeout_s=10)
    router = _wait_compiled(h)
    resp = h.remote(5)
    resps = [h.remote(i) for i in range(64)]
    return [first, type(resp).__name__, resp.result(timeout_s=10),
            [r.result(timeout_s=10) for r in resps] == [
                i * 2 for i in range(64)],
            router._compiled.mode, len(router._compiled.graph._lanes)]


# ------------------------------------------- tests/test_serve_compiled.py:63
def methods_and_errors_match_dynamic(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1, max_ongoing_requests=8)
    class Svc:
        def ping(self, x):
            return ("pong", x)

        async def aping(self, x):
            return ("apong", x)

        def boom(self, x):
            raise ValueError(f"boom-{x}")

        def __call__(self, x):
            return x + 1

    h = serve.run(Svc.bind(), name="app", route_prefix=None)
    router = _wait_compiled(h)
    # User exceptions arrive wrapped in TaskError with the original as
    # .cause; the replica survives (no teardown, still compiled).
    return [h.ping.remote(7).result(timeout_s=10),
            h.aping.remote(8).result(timeout_s=10),
            h.remote(1).result(timeout_s=10),
            _error(lambda: h.boom.remote(1).result(timeout_s=10)),
            h.remote(2).result(timeout_s=10), router._compiled.mode]


# ------------------------------------------- tests/test_serve_compiled.py:94
def await_and_composition(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1)
    class Inner:
        def __call__(self, x):
            return x * 10

    @serve.deployment(num_replicas=1)
    class Outer:
        def __init__(self, inner):
            self.inner = inner

        async def __call__(self, x):
            return (await self.inner.remote(x)) + 1

    h = serve.run(Outer.bind(Inner.bind()), name="app", route_prefix=None)
    _wait_compiled(h)

    async def main():
        return await h.remote(4)

    return [asyncio.run(main()), h.remote(5).result(timeout_s=10)]


# ------------------------------------------ tests/test_serve_compiled.py:118
def membership_change_tears_down_and_recompiles(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1, max_ongoing_requests=8)
    class Echo:
        def __call__(self, x):
            return x * 2

    recompiles = _router_mod(pkg).RECOMPILES_TOTAL
    tags = {"deployment": "app#Echo", "reason": "deploy"}
    base = recompiles.get(tags=tags)  # the counter is process-wide
    h = serve.run(Echo.bind(), name="app", route_prefix=None)
    router = _wait_compiled(h)
    mgr = router._compiled
    old_graph = mgr.graph
    # Scale up: the reconciler's push tears the graph down within the
    # long-poll callback, then it recompiles once the new set is stable.
    serve.run(Echo.options(num_replicas=3).bind(), name="app",
              route_prefix=None)
    answers = {h.remote(1).result(timeout_s=10)}
    deadline = time.time() + 10
    while mgr.graph is old_graph:
        assert time.time() < deadline, "graph not torn down on scale-up"
        answers.add(h.remote(1).result(timeout_s=10))  # no errors meanwhile
        time.sleep(0.02)
    _wait_compiled(h)
    return [sorted(answers), mgr.graph is not old_graph,
            len(mgr.graph._lanes),
            [h.remote(i).result(timeout_s=10) for i in range(16)],
            recompiles.get(tags=tags) - base]


# ------------------------------------------ tests/test_serve_compiled.py:144
def env_kill_switch_disables_compilation(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, x):
            return x + 1

    h = serve.run(Echo.bind(), name="app", route_prefix=None)
    first = h.remote(1).result(timeout_s=10)
    router = h._get_router()
    time.sleep(1.0)  # several stability windows + metric ticks
    return [first, router._compiled.mode, type(h.remote(2)).__name__]


# ------------------------------------------ tests/test_serve_compiled.py:163
def per_deployment_opt_out(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1, compiled_route=False)
    class Pinned:
        def __call__(self, x):
            return x + 1

    h = serve.run(Pinned.bind(), name="app", route_prefix=None)
    first = h.remote(1).result(timeout_s=10)
    time.sleep(1.0)
    return [first, h._get_router()._compiled.mode,
            type(h.remote(2)).__name__,
            Pinned.options(num_replicas=2).config.compiled_route]


# ------------------------------------------ tests/test_serve_compiled.py:175
def status_reports_route_mode(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1)
    class Echo:
        def __call__(self, x):
            return x

    h = serve.run(Echo.bind(), name="app", route_prefix=None)
    first = h.remote(1).result(timeout_s=10)
    _wait_compiled(h)
    deadline = time.time() + 5
    while True:  # the router reports its mode on the next metrics push
        mode = serve.status()["app#Echo"].get("route_mode")
        if mode == "compiled" or time.time() > deadline:
            break
        time.sleep(0.1)
    return [first, mode]


# ------------------------------------------ tests/test_serve_compiled.py:225
def multiplexed_model_routing(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class MuxSvc:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def load(self, model_id: str):
            return {"model": model_id}

        async def __call__(self, x):
            model = await self.load(serve.get_multiplexed_model_id())
            return (model["model"], x)

    h = serve.run(MuxSvc.bind(), name="app", route_prefix=None)
    _wait_compiled(h)
    return [h.options(multiplexed_model_id=f"m{i % 2}").remote(i).result(
        timeout_s=10) for i in range(8)]


# ------------------------------------------ tests/test_serve_compiled.py:246
def backpressure_sheds_on_compiled_path(pkg):
    serve = _serve(pkg)
    exc = importlib.import_module(pkg.__name__ + ".serve.exceptions")
    release = threading.Event()

    @serve.deployment(num_replicas=1, max_ongoing_requests=2,
                      max_queued_requests=0)
    class Slow:
        def __call__(self, x):
            release.wait(10)
            return x

    h = serve.run(Slow.bind(), name="app", route_prefix=None)
    _wait_compiled(h)
    resps = [h.remote(i) for i in range(2)]  # fill capacity
    time.sleep(0.2)
    try:
        h.remote(99)
        shed = None
    except exc.BackPressureError as e:
        shed = type(e).__name__
    release.set()
    return [shed, [type(r).__name__ for r in resps],
            [r.result(timeout_s=10) for r in resps]]


# ------------------------------------------ tests/test_serve_compiled.py:269
def steady_state_no_alloc(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class Echo:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.002)
        async def __call__(self, items):
            return [x for x in items]

    h = serve.run(Echo.bind(), name="app", route_prefix=None)
    router = _wait_compiled(h)
    graph = router._compiled.graph
    # Warm the slot ring.
    resps = [h.remote(i) for i in range(32)]
    warm = [r.result(timeout_s=10) for r in resps] == list(range(32))
    lanes = list(graph._lanes.values())
    before = sum(lane.req.slot_allocations for lane in lanes)
    # Steady state: every send reuses a pooled slot — zero new buffers.
    ok = True
    for _ in range(4):
        resps = [h.remote(i) for i in range(32)]
        ok = ok and [r.result(timeout_s=10) for r in resps] == list(range(32))
    after = sum(lane.req.slot_allocations for lane in lanes)
    return [warm, ok, after - before]


CASES = [compiles_after_stability_window, methods_and_errors_match_dynamic,
         await_and_composition, membership_change_tears_down_and_recompiles,
         per_deployment_opt_out, status_reports_route_mode,
         multiplexed_model_routing, backpressure_sheds_on_compiled_path,
         steady_state_no_alloc]

EXPECTED = {
    "compiles_after_stability_window": [6, "CompiledResponse", 10, True,
                                        "compiled", 2],
    "methods_and_errors_match_dynamic": [
        ("pong", 7), ("apong", 8), 2, ("TaskError", "ValueError"), 3,
        "compiled"],
    "await_and_composition": [41, 51],
    "membership_change_tears_down_and_recompiles": [
        [2], True, 3, [i * 2 for i in range(16)], 2.0],
    "env_kill_switch_disables_compilation": [2, "dynamic",
                                             "DeploymentResponse"],
    "per_deployment_opt_out": [2, "dynamic", "DeploymentResponse", False],
    "status_reports_route_mode": [1, "compiled"],
    "multiplexed_model_routing": [(f"m{i % 2}", i) for i in range(8)],
    "backpressure_sheds_on_compiled_path": [
        "BackPressureError", ["CompiledResponse"] * 2, [0, 1]],
    "steady_state_no_alloc": [True, True, 0],
}


def _run(pkg, case, monkeypatch, compiled="1"):
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED_STABLE_S", "0.2")
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED", compiled)
    fresh_init(pkg, num_cpus=8)
    serve = _serve(pkg)
    try:
        serve.start(http_options={"port": 0})
        return case(pkg)
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_port_compiled_route_matches_reference(case, monkeypatch):
    with gc_paused():
        ref = _run(ray_tpu, case, monkeypatch)
    port = _run(ray_tpu_torch, case, monkeypatch)
    assert ref == EXPECTED[case.__name__]
    assert port == ref


def test_env_kill_switch_matches_reference(monkeypatch):
    case = env_kill_switch_disables_compilation
    with gc_paused():
        ref = _run(ray_tpu, case, monkeypatch, compiled="0")
    port = _run(ray_tpu_torch, case, monkeypatch, compiled="0")
    assert ref == EXPECTED[case.__name__]
    assert port == ref


# ------------------------------------------ tests/test_serve_compiled.py:193
def process_tier_replicas_compile(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1, max_ongoing_requests=8,
                      ray_actor_options={"isolation": "process"})
    class Iso:
        def __call__(self, x):
            return x * 3

        def boom(self, x):
            raise ValueError(f"boom-{x}")

    h = serve.run(Iso.bind(), name="app", route_prefix=None)
    first = h.remote(2).result(timeout_s=60)
    # The set lowers onto shm-channel lanes with the loop in the worker.
    router = _wait_compiled(h, timeout=60)
    resp = h.remote(5)
    resps = [h.remote(i) for i in range(32)]
    return [first, type(resp).__name__, resp.result(timeout_s=60),
            [r.result(timeout_s=60) for r in resps] == [
                i * 3 for i in range(32)],
            _error(lambda: h.boom.remote(1).result(timeout_s=60)),
            h.remote(7).result(timeout_s=60), router._compiled.mode,
            type(next(iter(router._compiled.graph._lanes.values()))).__name__]


def child_half(pkg_name, case_name):
    """One half of a case in this (child) interpreter, as ``_run`` runs it."""
    os.environ["RAY_TPU_SERVE_COMPILED_STABLE_S"] = "0.2"
    os.environ["RAY_TPU_SERVE_COMPILED"] = "1"
    pkg = importlib.import_module(pkg_name)
    fresh_init(pkg, num_cpus=8)
    serve = _serve(pkg)
    try:
        serve.start(http_options={"port": 0})
        return globals()[case_name](pkg)
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


def test_process_tier_replicas_compile(monkeypatch):
    case = process_tier_replicas_compile
    ref = in_child("test_torch_serve_compiled", "child_half", "ray_tpu",
                   case.__name__)
    port = as_json(_run(ray_tpu_torch, case, monkeypatch))
    assert ref == [6, "CompiledResponse", 15, True, ["TaskError",
                                                     "ValueError"],
                   21, "compiled", "_ProcessLane"]
    assert port == ref


def test_process_lane_takes_concurrent_callers(monkeypatch):
    """Eight handle clients at once on a process replica's compiled lane
    (every caller writes the lane's request channel from its own thread):
    all 128 answers come back, right, and the route stays compiled."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED_STABLE_S", "0.2")
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED", "1")
    fresh_init(ray_tpu_torch, num_cpus=8)
    serve = ray_tpu_torch.serve
    try:
        serve.start(http_options={"port": 0})

        @serve.deployment(num_replicas=1, max_ongoing_requests=64,
                          ray_actor_options={"isolation": "process"})
        class Iso:
            def __call__(self, x):
                return x * 3

        h = serve.run(Iso.bind(), name="app", route_prefix=None)
        h.remote(0).result(timeout_s=60)
        router = _wait_compiled(h, timeout=60)
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(
                lambda i: h.remote(i).result(timeout_s=60), range(128)))
        assert got == [i * 3 for i in range(128)]
        assert router._compiled.mode == "compiled"
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


_SHUTDOWN_ROUNDS = """
import os, sys, threading, time
os.environ["RAY_TPU_SERVE_COMPILED_STABLE_S"] = "0.1"
import ray_tpu_torch
from ray_tpu_torch import serve

def lanes():
    # A lane's own threads; a request re-dispatched at the teardown waits
    # in the router for replicas (up to its 30 s) like any dynamic one.
    return [t.name for t in threading.enumerate() if t.name.startswith(
        ("serve-compiled-loop", "serve-compiled-demux",
         "serve-compiled-ploop", "serve-compiled-pdemux"))]

@serve.deployment(num_replicas=1, max_ongoing_requests=16,
                  ray_actor_options={"isolation": "process"})
class Iso:
    def __call__(self, x):
        return x + 1

seen = []
for i in range(ROUNDS):
    rt = ray_tpu_torch.init(num_cpus=8)
    arena = rt.store.arena_path
    serve.start(http_options={"port": 0})
    h = serve.run(Iso.bind(), name="app", route_prefix=None)
    h.remote(0).result(timeout_s=60)
    deadline = time.monotonic() + 30
    while h._get_router()._compiled.mode != "compiled":
        assert time.monotonic() < deadline, "never compiled"
        time.sleep(0.01)
    stop, answered = threading.Event(), [0]

    def client():
        while not stop.is_set():
            try:
                h.remote(1).result(timeout_s=10)
                answered[0] += 1
            except Exception:
                pass

    clients = [threading.Thread(target=client, daemon=True)
               for _ in range(4)]
    for c in clients:
        c.start()
    time.sleep(0.2)
    pids = rt.process_pool.idle_pids() + [
        w.proc.pid for w in rt.process_pool._started]
    serve.shutdown()
    ray_tpu_torch.shutdown()
    stop.set()  # a client parked in the router ends on its own
    time.sleep(0.2)
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    seen.append((answered[0] > 0, lanes(), os.path.exists(arena), alive))
print("ROUNDS", all(s == (True, [], False, []) for s in seen), seen[:2])
"""


def test_shutdown_under_compiled_load_on_process_replicas_20_times():
    """Twenty rounds of serve and runtime shutdown while four clients send
    on a process replica's compiled lane, in a child interpreter so a crash
    fails the case: each round answered, and left no lane thread, no arena
    file and no worker process (the reference's demux read its arena after
    its shutdown once and segfaulted)."""
    out = subprocess.run(
        [sys.executable, "-c", _SHUTDOWN_ROUNDS.replace("ROUNDS", "20", 1)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=os.path.dirname(os.path.dirname(
                     os.path.abspath(__file__)))))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ROUNDS True" in out.stdout, out.stdout[-2000:]


def test_route_threads_end_with_serve(monkeypatch):
    """The lanes' loop and demux threads end once serve and its runtime
    shut down, and the route's own counters say it compiled once."""
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED_STABLE_S", "0.2")
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED", "1")
    # Threads of earlier cases in this process (the reference's process
    # lanes among them) are not this route's.
    before = set(threading.enumerate())

    def lanes():
        return sorted(t.name for t in threading.enumerate()
                      if t not in before
                      and t.name.startswith("serve-compiled-"))

    fresh_init(ray_tpu_torch, num_cpus=8)
    serve = ray_tpu_torch.serve
    try:
        serve.start(http_options={"port": 0})

        @serve.deployment(num_replicas=2)
        def echo(x):
            return x

        h = serve.run(echo.bind(), name="lanes", route_prefix=None)
        _wait_compiled(h)
        assert [h.remote(i).result(timeout_s=10) for i in range(8)] == list(
            range(8))
        # A loop and a demux per replica.
        assert [n.rsplit("#", 1)[0] for n in lanes()] == [
            "serve-compiled-demux-echo", "serve-compiled-demux-echo",
            "serve-compiled-loop-echo", "serve-compiled-loop-echo"]
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    deadline = time.time() + 10
    while time.time() < deadline and lanes():
        time.sleep(0.05)
    assert lanes() == []
