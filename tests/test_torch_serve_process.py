"""The port's process-tier serve replicas (``SyncReplicaActor``) against the
reference's on the cases of tests/test_serve_extras.py, and GPT-2 served
from a process replica against the JAX forward.

Each parity case is one body run against both packages, one after the
other, each on a fresh runtime and serve instance torn down before the
other starts; the port's observation must equal the reference's. Every
result and HTTP call has a timeout.
"""

import dataclasses
import importlib
import json
import os
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2

T = 60  # seconds any one result may wait
CASE_S = 240  # seconds one package's half of a parity case may take


def _serve(pkg):
    return importlib.import_module(pkg.__name__ + ".serve")


# --------------------------------------------- tests/test_serve_extras.py
def process_tier_replica(pkg):
    serve = _serve(pkg)

    @serve.deployment(ray_actor_options={"isolation": "process"})
    class PidReporter:
        def __call__(self, _=None):
            return {"pid": os.getpid()}

    handle = serve.run(PidReporter.bind(), name="pids", route_prefix=None)
    return handle.remote(None).result(timeout_s=T)["pid"] != os.getpid()


def process_tier_replica_async_callable(pkg):
    serve = _serve(pkg)

    @serve.deployment(ray_actor_options={"isolation": "process"})
    class AsyncSquare:
        async def __call__(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x * x

    handle = serve.run(AsyncSquare.bind(), name="async_sq", route_prefix=None)
    return handle.remote(7).result(timeout_s=T)


def streaming_process_tier_replica(pkg):
    serve = _serve(pkg)

    @serve.deployment(ray_actor_options={"isolation": "process"})
    class ProcStreamer:
        def count(self, n):
            for i in range(n):
                yield {"i": i, "pid": os.getpid()}

    handle = serve.run(ProcStreamer.bind(), name="proc_stream",
                       route_prefix=None)
    items = list(handle.options(method_name="count", stream=True).remote(3))
    return [[it["i"] for it in items], items[0]["pid"] != os.getpid()]


def process_replica_concurrent_requests(pkg):
    serve = _serve(pkg)

    @serve.deployment(ray_actor_options={"isolation": "process"},
                      max_ongoing_requests=3)
    class SlowProc:
        def __call__(self, s):
            time.sleep(float(s))
            return os.getpid()

    handle = serve.run(SlowProc.bind(), name="slowproc", route_prefix=None)
    handle.remote(0.01).result(timeout_s=T)  # absorb the spawn
    t0 = time.monotonic()
    rs = [handle.remote(0.8) for _ in range(3)]
    pids = {r.result(timeout_s=T) for r in rs}
    return [len(pids), time.monotonic() - t0 < 2.0]


def process_replica_over_http(pkg):
    """A process replica behind the HTTP proxy: unary JSON and a stream."""
    serve = _serve(pkg)

    @serve.deployment(ray_actor_options={"isolation": "process"})
    class Echo:
        async def __call__(self, request):
            body = await request.json()
            return {"sum": sum(body["xs"]), "proc": os.getpid() != DRIVER}

    @serve.deployment(ray_actor_options={"isolation": "process"})
    class Ticker:
        def __call__(self, request):
            for i in range(int(request.query_params.get("n", "3"))):
                yield json.dumps({"tick": i})

    DRIVER = os.getpid()
    serve.run(Echo.bind(), name="echo", route_prefix="/echo")
    serve.run(Ticker.bind(), name="ticker", route_prefix="/ticker")
    proxy = importlib.import_module(pkg.__name__ + ".serve.api")._state["proxy"]
    base = f"http://127.0.0.1:{proxy._options.port}"
    req = urllib.request.Request(
        base + "/echo", data=json.dumps({"xs": [1, 2, 3]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=T) as resp:
        unary = [resp.status, json.loads(resp.read())]
    req = urllib.request.Request(base + "/ticker?n=4",
                                 headers={"Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=T) as resp:
        events = [json.loads(line[len(b"data: "):]) for line in resp
                  if line.startswith(b"data: ")]
    return [unary, events]


CASES = [
    (process_tier_replica, True),
    (process_tier_replica_async_callable, 49),
    (streaming_process_tier_replica, [[0, 1, 2], True]),
    (process_replica_concurrent_requests, [1, True]),
    (process_replica_over_http,
     [[200, {"sum": 6, "proc": True}], [{"tick": i} for i in range(4)]]),
]


def _run(pkg, case):
    fresh_init(pkg, num_cpus=4)
    serve = _serve(pkg)
    serve.start(http_options={"port": 0})
    try:
        return bounded(lambda: case(pkg), CASE_S)
    finally:
        serve.shutdown()
        pkg.shutdown()


@pytest.mark.parametrize("case,expected", CASES,
                         ids=[c.__name__ for c, _ in CASES])
def test_process_replica_matches_reference(case, expected):
    with gc_paused():
        ref = _run(ray_tpu, case)
    port = _run(ray_tpu_torch, case)
    assert ref == expected
    assert port == ref


def test_async_generator_cannot_stream_from_a_process_replica():
    """Only sync generators stream from a process replica: an async one
    cannot resume across the per-call event loops, and the error names the
    thread tier."""
    fresh_init(ray_tpu_torch, num_cpus=4)
    serve = _serve(ray_tpu_torch)
    serve.start(http_options={"port": 0})
    try:
        @serve.deployment(ray_actor_options={"isolation": "process"})
        class AsyncGen:
            async def count(self, n):
                for i in range(n):
                    yield i

        handle = serve.run(AsyncGen.bind(), name="agen", route_prefix=None)
        gen = handle.options(method_name="count", stream=True).remote(2)
        with pytest.raises(Exception, match="SYNC generators"):
            bounded(lambda: list(gen), T)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


# ------------------------------------------------------- GPT-2 in a process
_TIE_TOL = 1e-4  # fp32 on both sides (tests/test_torch_serve_gpt2.py)


def test_gpt2_process_replica_matches_jax():
    """GPT-2 tiny (JAX weights through models.convert) behind serve.run on a
    process replica on the CPU: its next token keeps the tie rule against
    the JAX forward, and its logits equal the JAX logits within the
    tolerance of tests/test_torch_serve_gpt2.py; the replica's process is
    not the driver's."""
    jcfg = dataclasses.replace(jgpt2.GPTConfig.tiny(), dtype=jnp.float32,
                               logits_dtype=jnp.float32, attn_impl="xla")
    tcfg = dataclasses.replace(tgpt2.GPTConfig.tiny(), dtype=torch.float32,
                               logits_dtype=torch.float32, attn_impl="auto")
    jparams = jax.tree.map(np.asarray,
                           jgpt2.init_params(jcfg, jax.random.key(0)))
    tparams = convert.params_from_numpy(jparams, device="cpu")
    fwd = jax.jit(lambda p, t: jgpt2.forward(p, t, jcfg))
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, jcfg.vocab_size, n).tolist()
                for n in (1, 17, jcfg.seq_len)]

    serve = _serve(ray_tpu_torch)

    class PidNext(serve.GPT2Next):
        def pid(self):
            return os.getpid()

    fresh_init(ray_tpu_torch, num_cpus=4)
    serve.start(http_options={"port": 0})
    try:
        handle = serve.run(
            serve.deployment(ray_actor_options={"isolation": "process"})(
                PidNext).bind(tcfg, device="cpu", params=tparams),
            name="gpt2", route_prefix="/gpt2")
        assert handle.pid.remote().result(timeout_s=T) != os.getpid()
        proxy = serve.api._state["proxy"]
        for toks in requests:
            ref = np.asarray(fwd(jparams, jnp.asarray([toks], jnp.int32)))[
                0, -1]
            logits = handle.logits.remote(toks).result(timeout_s=T)
            assert logits.device.type == "cpu"
            np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4,
                                       atol=1e-4)
            req = urllib.request.Request(
                f"http://127.0.0.1:{proxy._options.port}/gpt2",
                data=json.dumps({"tokens": toks}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=T) as resp:
                chosen = json.loads(resp.read())["next_token"]
            assert ref[chosen] >= ref.max() - _TIE_TOL
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
