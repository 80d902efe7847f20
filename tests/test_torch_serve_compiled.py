"""The port's compiled steady-state serve route
(``ray_tpu_torch/serve/compiled_router.py``) against the reference's, on
the cases of tests/test_serve_compiled.py: lowering after the stability
window, batch fusion, parity with the dynamic path (results, methods,
errors, composition, multiplexing), teardown and recompilation on a
membership change, the two switches (``RAY_TPU_SERVE_COMPILED=0`` and
``compiled_route=False``), ``serve.status()``'s route mode, shedding, and
the slot ring's steady state.

In place of tests/test_serve_compiled.py:193 (the reference lowers a
process-tier replica onto lanes over its shared-memory arena), the port's
own case: a process replica keeps the dynamic route and answers; the lane
needs ROADMAP.md Queue 1 item 11b-2.

Each case is one body run on ``ray_tpu`` and then on ``ray_tpu_torch``,
each on a fresh runtime and serve instance with a 0.2 s stability window,
the reference's half under ``gc_paused`` (tests/_torch_runtimes.py says
why); the observations must be equal.
"""

import asyncio
import importlib
import threading
import time

import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve
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


# ------------------------------------------------------ the port's own rule
def test_process_replica_keeps_the_dynamic_route(monkeypatch):
    """A process-tier replica has no instance in this heap: its lane would
    need the shared-memory channels (ROADMAP.md, Queue 1 item 11b-2), so
    the route stays dynamic — answers and errors as the dynamic path gives
    them, and ``route_mode`` "dynamic" — and the manager does not retry
    the set every tick."""
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED_STABLE_S", "0.2")
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED", "1")
    fresh_init(ray_tpu_torch, num_cpus=8)
    serve = ray_tpu_torch.serve
    try:
        serve.start(http_options={"port": 0})

        @serve.deployment(num_replicas=1, max_ongoing_requests=8,
                          ray_actor_options={"isolation": "process"})
        class Iso:
            def __call__(self, x):
                return x * 3

            def boom(self, x):
                raise ValueError(f"boom-{x}")

        h = serve.run(Iso.bind(), name="app", route_prefix=None)
        assert h.remote(2).result(timeout_s=60) == 6
        time.sleep(1.0)  # several stability windows + metric ticks
        mgr = h._get_router()._compiled
        assert mgr.mode == "dynamic"
        assert mgr._uncompilable_sig == mgr._sig != ()
        resps = [h.remote(i) for i in range(32)]
        assert {type(r).__name__ for r in resps} == {"DeploymentResponse"}
        assert [r.result(timeout_s=60) for r in resps] == [
            i * 3 for i in range(32)]
        with pytest.raises(Exception, match="boom-1"):
            h.boom.remote(1).result(timeout_s=60)
        assert serve.status()["app#Iso"]["route_mode"] == "dynamic"
        from ray_tpu_torch.serve.compiled_router import RECOMPILES_TOTAL

        assert RECOMPILES_TOTAL.get(
            tags={"deployment": "app#Iso", "reason": "deploy"}) == 0
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


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
