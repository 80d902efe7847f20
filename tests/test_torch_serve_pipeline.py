"""The port's multi-stage compiled serve graphs (``serve.pipeline``,
``ServePipeline``) against the reference's, on the cases of
tests/test_serve_pipeline.py: stage-to-stage forwarding over typed channel
edges with the caller's future riding the whole chain, awaiting it, per-hop
dynamic degradation through a membership change with no caller-visible
error, stages by name with per-stage methods, and validation.

In place of tests/test_serve_pipeline.py:156 (a process-tier stage on the
reference's shared-memory lanes), the port's own case: a process stage's
hop stays dynamic (ROADMAP.md, Queue 1 item 11b-2), the pipeline as a whole
reads "dynamic", and its results equal the reference's pipeline's.

Each case is one body run on ``ray_tpu`` and then on ``ray_tpu_torch``,
each on a fresh runtime and serve instance with a 0.2 s stability window,
the reference's half under ``gc_paused``; the observations must be equal.
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


def _wait_compiled(handle, timeout=8.0):
    router = handle._get_router()
    deadline = time.time() + timeout
    while router._compiled.mode != "compiled":
        if time.time() > deadline:
            raise AssertionError("route never compiled")
        time.sleep(0.02)
    return router


def _stages(serve):
    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class Prefill:
        def __call__(self, x):
            return x + 1

    @serve.deployment(num_replicas=2, max_ongoing_requests=16)
    class Decode:
        def __call__(self, x):
            return x * 10

    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class Post:
        def __call__(self, x):
            return f"out:{x}"

    return Prefill, Decode, Post


def _run_three_stages(serve):
    prefill, decode, post = _stages(serve)
    h1 = serve.run(prefill.bind(), name="p1", route_prefix=None)
    h2 = serve.run(decode.bind(), name="p2", route_prefix=None)
    h3 = serve.run(post.bind(), name="p3", route_prefix=None)
    return (h1, h2, h3), decode


# ------------------------------------------- tests/test_serve_pipeline.py:60
def pipeline_end_to_end(pkg):
    serve = _serve(pkg)
    (h1, h2, h3), _ = _run_three_stages(serve)
    pipe = serve.pipeline(h1, h2, h3, name="e2e")
    forwards = importlib.import_module(
        pkg.__name__ + ".serve.compiled_router").PIPELINE_FORWARDS
    base = forwards.get(tags={"pipeline": "e2e"})
    try:
        # Before any stage compiles every hop is dynamic; the chain must
        # already give the final stage's result.
        first = pipe.remote(4).result(timeout_s=30)
        _wait_compiled(h1), _wait_compiled(h2), _wait_compiled(h3)
        mode = pipe.mode
        again = pipe.remote(4).result(timeout_s=10)
        resps = [pipe.remote(i) for i in range(64)]
        burst = [r.result(timeout_s=15) for r in resps]
        return [first, mode, again, type(resps[0]).__name__,
                burst == [f"out:{(i + 1) * 10}" for i in range(64)],
                pipe._edges_built,
                # Two hops a request: 66 requests, 132 forwards.
                forwards.get(tags={"pipeline": "e2e"}) - base]
    finally:
        pipe.stop()


# ------------------------------------------- tests/test_serve_pipeline.py:84
def pipeline_is_awaitable(pkg):
    serve = _serve(pkg)
    (h1, h2, h3), _ = _run_three_stages(serve)
    pipe = serve.pipeline(h1, h2, h3, name="aw")
    try:
        _wait_compiled(h2)

        async def main():
            return await pipe.remote(8)

        return asyncio.run(main())
    finally:
        pipe.stop()


# ------------------------------------------ tests/test_serve_pipeline.py:100
def pipeline_membership_change_zero_errors(pkg):
    """Scaling the middle stage mid-traffic tears its compiled route down
    and closes the pipeline's edges; every request in flight and after
    still resolves correctly, and the pipeline lowers again."""
    serve = _serve(pkg)
    (h1, h2, h3), decode = _run_three_stages(serve)
    pipe = serve.pipeline(h1, h2, h3, name="member")
    errors, wrong = [], []
    ok = [0]
    stop = threading.Event()

    def pound(tid):
        i = tid * 100000
        while not stop.is_set():
            try:
                v = pipe.remote(i).result(timeout_s=30)
                if v != f"out:{(i + 1) * 10}":
                    wrong.append((v, i))
                ok[0] += 1
            except Exception as e:  # noqa: BLE001 — recorded, case fails
                errors.append(repr(e))
                return
            i += 1

    try:
        _wait_compiled(h1), _wait_compiled(h2), _wait_compiled(h3)
        threads = [threading.Thread(target=pound, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        serve.run(decode.options(num_replicas=3).bind(), name="p2",
                  route_prefix=None)
        time.sleep(1.2)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        alive = [t.is_alive() for t in threads]
        _wait_compiled(h2)
        # The stage recompiles around the new set; the pipeline re-lowers.
        return [errors[:3], wrong[:3], ok[0] > 50, alive,
                pipe.remote(9).result(timeout_s=10), pipe.mode,
                len(h2._get_router()._compiled.graph._lanes)]
    finally:
        stop.set()
        pipe.stop()


# ------------------------------------------ tests/test_serve_pipeline.py:172
def pipeline_by_name_and_methods(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1)
    class Named:
        def enc(self, x):
            return x + 100

        def dec(self, x):
            return x - 1

    serve.run(Named.bind(), name="default", route_prefix=None)
    # Stage by deployment name, per-stage method override.
    pipe = serve.pipeline("Named", "Named", methods=["enc", "dec"],
                          name="named")
    try:
        return pipe.remote(1).result(timeout_s=30)
    finally:
        pipe.stop()


# ------------------------------------------ tests/test_serve_pipeline.py:191
def pipeline_validation(pkg):
    serve = _serve(pkg)
    prefill, _, _ = _stages(serve)
    h1 = serve.run(prefill.bind(), name="p1", route_prefix=None)
    out = []
    for kw in ({}, {"methods": ["a"]}, {"devices": [None, None]}):
        stages = (h1,) if not kw else (h1, h1)
        try:
            serve.pipeline(*stages, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    pipe = serve.pipeline(h1, h1, name="stopme")
    pipe.stop()
    try:
        pipe.remote(1)
        out.append(None)
    except RuntimeError as e:
        out.append(str(e))
    return out


CASES = [pipeline_end_to_end, pipeline_is_awaitable,
         pipeline_membership_change_zero_errors, pipeline_by_name_and_methods,
         pipeline_validation]

EXPECTED = {
    "pipeline_end_to_end": ["out:50", "compiled", "out:50",
                            "CompiledResponse", True, True, 132.0],
    "pipeline_is_awaitable": "out:90",
    "pipeline_membership_change_zero_errors": [
        [], [], True, [False] * 4, "out:100", "compiled", 3],
    "pipeline_by_name_and_methods": 100,
    "pipeline_validation": [
        "a serve pipeline needs at least two stages",
        "methods must match stages 1:1",
        "devices must match inter-stage edges 1:1 (one fewer than stages)",
        "pipeline 'stopme' is stopped"],
}


def _run(pkg, case, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED_STABLE_S", "0.2")
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED", "1")
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
def test_port_pipeline_matches_reference(case, monkeypatch):
    with gc_paused():
        ref = _run(ray_tpu, case, monkeypatch)
    port = _run(ray_tpu_torch, case, monkeypatch)
    assert ref == EXPECTED[case.__name__]
    assert port == ref


# ----------------------------------------- in place of test_serve_pipeline.py:156
def _mixed_tiers(pkg, isolation):
    """A thread stage chained with a second stage, on the process tier in
    the port's half. The reference's half keeps its second stage on the
    thread tier: its process-tier lane reads the shared-memory arena from
    a demux thread that can outlive the arena at shutdown (a segfault seen
    in this file's runs), and the answers are the same either way."""
    serve = _serve(pkg)
    prefill, _, _ = _stages(serve)

    @serve.deployment(num_replicas=1, max_ongoing_requests=8,
                      ray_actor_options={"isolation": isolation})
    class Mid:
        def __call__(self, x):
            return x - 1

    h1 = serve.run(prefill.bind(), name="p1", route_prefix=None)
    hm = serve.run(Mid.bind(), name="pm", route_prefix=None)
    pipe = serve.pipeline(h1, hm, name="mix")
    try:
        first = pipe.remote(10).result(timeout_s=60)
        _wait_compiled(h1)
        time.sleep(1.0)  # the second stage's windows pass too
        resps = [pipe.remote(i) for i in range(16)]
        return ([first] + [r.result(timeout_s=60) for r in resps],
                hm._get_router()._compiled.mode, pipe.mode,
                [type(r).__name__ for r in resps[:1]])
    finally:
        pipe.stop()


def test_process_stage_hop_stays_dynamic(monkeypatch):
    with gc_paused():
        ref = _run(ray_tpu, lambda pkg: _mixed_tiers(pkg, "thread"),
                   monkeypatch)
    port = _run(ray_tpu_torch, lambda pkg: _mixed_tiers(pkg, "process"),
                monkeypatch)
    assert ref[0] == port[0] == [10] + list(range(16))
    assert ref[1:] == ("compiled", "compiled", ["CompiledResponse"])
    # The first hop still rides its lane; the process stage's is dynamic.
    assert port[1:] == ("dynamic", "dynamic", ["CompiledResponse"])
