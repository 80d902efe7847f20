"""The port's model multiplexing (ray_tpu_torch.serve.multiplex, the
router's warm-replica preference, the warm pool's prewarm) and a client
leaving a continuously batched HTTP stream, against the reference
(ray_tpu.serve); then the port's ``GPT2MultiplexNext`` on the CPU.

Each parity case is one body run on ``ray_tpu`` and then on
``ray_tpu_torch``, each on a fresh runtime and serve instance torn down
before the other starts, and the observations must be equal. The
reference's half runs with the cyclic collector paused
(tests/_torch_runtimes.py says why); the port's half runs with it on.
"""

import asyncio
import gc
import http.client
import importlib
import itertools
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve
from _torch_runtimes import fresh_init, gc_paused

#: (replica id, model id) of every load, appended by the loaders of this
#: file's deployments: the replicas are threads of this process.
_LOADS = []


def _serve(pkg):
    return importlib.import_module(pkg.__name__ + ".serve")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.serve.{name}")


def _replica_id(pkg):
    return _mod(pkg, "context").get_internal_replica_context().replica_id


def _router_view(handle):
    """The model ids each replica holds, as the handle's router sees them."""
    scheduler = handle._get_router()._scheduler
    with scheduler._lock:
        return {r["replica_id"]: list(r.get("multiplexed_model_ids") or ())
                for r in scheduler._replicas}


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


# ------------------------------------------------------- tests/test_serve.py
def multiplexed_models(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return {"model": model_id, "loaded_at": time.time()}

        async def __call__(self, model_id):
            model = await self.get_model(model_id)
            return (model["model"], serve.get_multiplexed_model_id())

    handle = serve.run(MultiModel.bind(), name="mux", route_prefix=None)
    out = [handle.remote(m).result(timeout_s=10) for m in ("m1", "m2", "m3")]
    (replica,) = handle._get_router()._scheduler._replicas
    meta = pkg.get(replica["actor"].get_metadata.remote(), timeout=10)
    # The controller folds the replica's ids into the routers' replica set.
    seen = _wait(lambda: list(_router_view(handle).values()) == [["m2", "m3"]])
    return [out, meta["multiplexed_model_ids"], seen]


# --------------------------------------------------- LRU and the unload hook
def lru_eviction_runs_the_unload_hook(pkg):
    mux = _mod(pkg, "multiplex")
    events = []

    class Closable:
        def __init__(self, model_id):
            self.model_id = model_id

        def close(self):
            events.append(("close", self.model_id))

    async def async_unload(self, model_id, model):
        await asyncio.sleep(0)
        events.append(("unload", model_id, model))

    class Holder:
        @mux.multiplexed(max_num_models_per_replica=2, unload=async_unload)
        async def get_model(self, model_id):
            events.append(("load", model_id))
            return model_id.upper()

    @mux.multiplexed(max_num_models_per_replica=1)
    async def load_closable(model_id):
        events.append(("load", model_id))
        return Closable(model_id)

    tags = {"deployment": ""}
    loads0 = mux.MODEL_LOADS.get(tags=tags)
    evictions0 = mux.MODEL_EVICTIONS.get(tags=tags)

    async def main():
        holder = Holder()
        got = [await holder.get_model(m) for m in ("a", "b", "a", "c", "b")]
        (wrapper,) = Holder.get_model._multiplex_wrappers.values()
        lru = wrapper.loaded_model_ids
        for m in ("x", "y"):
            await load_closable(m)
        await wrapper.unload_all()
        errors = []
        for bad in ("", 3):
            try:
                await holder.get_model(bad)
            except TypeError as e:
                errors.append(str(e))
        return got, lru, wrapper.loaded_model_ids, errors

    got, lru, after, errors = asyncio.run(main())
    return [got, lru, after, errors, events,
            mux.MODEL_LOADS.get(tags=tags) - loads0,
            mux.MODEL_EVICTIONS.get(tags=tags) - evictions0,
            mux.MODELS_LOADED_GAUGE.get(tags=tags)]


def multiplexed_loader_rejects_sync(pkg):
    mux = _mod(pkg, "multiplex")
    try:
        @mux.multiplexed
        def load(model_id):
            return model_id
    except TypeError as e:
        return str(e)


# ------------------------------------------------- routing by model id
def warm_routing_across_two_replicas(pkg):
    serve = _serve(pkg)
    _LOADS.clear()

    @serve.deployment(num_replicas=2)
    class Mux:
        @serve.multiplexed(max_num_models_per_replica=1)
        async def get_model(self, model_id):
            _LOADS.append((_replica_id(pkg), model_id))
            await asyncio.sleep(0.2)  # a load takes time, as weights do
            return model_id

        async def __call__(self, x):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model, _replica_id(pkg), x

    handle = serve.run(Mux.bind(), name="warm", route_prefix=None)
    h1 = handle.options(multiplexed_model_id="m1")
    h2 = handle.options(multiplexed_model_id="m2")
    # The pair goes out together: the second request sees the first in
    # flight and takes the other replica.
    first = [r.result(timeout_s=10) for r in (h1.remote(0), h2.remote(0))]
    warm = _wait(lambda: sorted(map(tuple, _router_view(handle).values()))
                 == [("m1",), ("m2",)])
    loads_before = len(_LOADS)
    later = [(h1 if i % 2 == 0 else h2).remote(i).result(timeout_s=10)
             for i in range(1, 9)]
    home = {model: rid for model, rid, _ in first}
    return [home["m1"] != home["m2"], warm, loads_before,
            len(_LOADS) - loads_before,
            [model for model, _, _ in later],
            all(rid == home[model] for model, rid, _ in later),
            [x for _, _, x in later]]


def batches_never_mix_model_ids(pkg):
    serve = _serve(pkg)
    batches = []

    class Batched:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def infer(self, items):
            mid = serve.get_multiplexed_model_id()
            batches.append((mid, [m for m, _ in items]))
            return [(mid, x) for _, x in items]

        async def __call__(self, x):
            return await self.infer((serve.get_multiplexed_model_id(), x))

    handle = serve.run(serve.deployment(max_ongoing_requests=32)(Batched)
                       .bind(), name="batched", route_prefix=None)
    hs = {m: handle.options(multiplexed_model_id=m) for m in ("m1", "m2")}
    refs = [hs["m1" if i % 2 == 0 else "m2"].remote(i) for i in range(12)]
    out = [r.result(timeout_s=20) for r in refs]
    queues = sorted(q.model_id for q in Batched.infer._batch_queues.values())
    return [out, queues,
            sorted({(mid, tuple(sorted(set(ids)))) for mid, ids in batches}),
            {m: sum(len(ids) for mid, ids in batches if mid == m)
             for m in ("m1", "m2")}]


# -------------------------------------------------- the warm pool's prewarm
def prewarm_through_the_warm_pool(pkg):
    serve = _serve(pkg)
    _LOADS.clear()

    @serve.deployment(autoscaling_config=dict(
        min_replicas=1, max_replicas=2, initial_replicas=1, warm_pool_size=1,
        prewarm_model_ids=["m1", "m2"]))
    class Warm:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id):
            _LOADS.append((_replica_id(pkg), model_id))
            return model_id

        async def __call__(self, x):
            return await self.get_model(serve.get_multiplexed_model_id())

    handle = serve.run(Warm.bind(), name="prewarm", route_prefix=None)

    def warm_rows():
        return [r for r in serve.list_replicas()
                if r["deployment"] == "Warm" and r["warm"]
                and r["state"] == "WARM"]

    def prewarmed():
        rows = warm_rows()
        return rows and sorted(m for rid, m in list(_LOADS)
                               if rid == rows[0]["replica_id"]) == ["m1",
                                                                   "m2"]

    done = _wait(prewarmed)
    (warm_id,) = [r["replica_id"] for r in warm_rows()]
    served = handle.options(multiplexed_model_id="m2").remote(0).result(
        timeout_s=10)
    by_replica = {}
    for rid, model in _LOADS:
        by_replica.setdefault("warm" if rid == warm_id else "serving",
                              []).append(model)
    return [done, served, {k: sorted(v) for k, v in by_replica.items()},
            serve.status()["prewarm#Warm"]["autoscale"]["warm_replicas"]]


# ------------------------------------- a client leaving a continuous stream
def http_client_leaving_a_stream_retires_its_slot(pkg):
    serve = _serve(pkg)
    steps = []

    @serve.deployment(max_ongoing_requests=8)
    class Endless:
        @serve.continuous_batch(max_batch_size=4)
        async def __call__(self, slots):
            steps.append(len(slots))
            await asyncio.sleep(0.01)
            outs = []
            for s in slots:
                i = s.state.setdefault("i", 0)
                s.state["i"] = i + 1
                outs.append(f"tok{i} ")
            return outs

    handle = serve.run(Endless.bind(), name="endless",
                       route_prefix="/endless")
    opts = importlib.import_module(
        pkg.__name__ + ".serve.api")._state["proxy"]._options
    conn = http.client.HTTPConnection(opts.host, opts.port, timeout=30)
    conn.request("GET", "/endless", headers={"Accept": "text/event-stream"})
    resp = conn.getresponse()
    status, ctype = resp.status, resp.getheader("Content-Type")
    got = b""
    while got.count(b"data: ") < 3:
        got += resp.read1(4096)
    conn.close()  # the client leaves mid-stream

    def quiet():
        n = len(steps)
        time.sleep(0.3)
        return len(steps) == n

    stopped = _wait(quiet)
    router = handle._get_router()
    router._replicas_populated.wait(10)
    (replica,) = router._scheduler._replicas
    ongoing = _wait(lambda: pkg.get(
        replica["actor"].get_num_ongoing_requests.remote(), timeout=10) == 0)
    first = [e.strip() for e in got.decode().split("data: ") if e][:3]
    return [status, ctype, first, stopped, ongoing, max(steps)]


CASES = [multiplexed_models, warm_routing_across_two_replicas,
         batches_never_mix_model_ids, prewarm_through_the_warm_pool,
         http_client_leaving_a_stream_retires_its_slot]
LOCAL_CASES = [lru_eviction_runs_the_unload_hook,
               multiplexed_loader_rejects_sync]

EXPECTED = {
    "multiplexed_models": [[("m1", "m1"), ("m2", "m2"), ("m3", "m3")],
                           ["m2", "m3"], True],
    "warm_routing_across_two_replicas": [
        True, True, 2, 0, ["m2", "m1", "m2", "m1", "m2", "m1", "m2", "m1"],
        True, list(range(1, 9))],
    "batches_never_mix_model_ids": [
        [("m1" if i % 2 == 0 else "m2", i) for i in range(12)], ["m1", "m2"],
        [("m1", ("m1",)), ("m2", ("m2",))], {"m1": 6, "m2": 6}],
    "prewarm_through_the_warm_pool": [True, "m2",
                                      {"warm": ["m1", "m2"],
                                       "serving": ["m2"]}, 1],
    "http_client_leaving_a_stream_retires_its_slot": [
        200, "text/event-stream", ["tok0", "tok1", "tok2"], True, True, 1],
    "lru_eviction_runs_the_unload_hook": [
        ["A", "B", "A", "C", "B"], ["c", "b"], [], [
            "model_id must be a non-empty string"] * 2,
        [("load", "a"), ("load", "b"), ("unload", "b", "B"), ("load", "c"),
         ("unload", "a", "A"), ("load", "b"), ("load", "x"), ("close", "x"),
         ("load", "y"), ("unload", "c", "C"), ("unload", "b", "B")],
        6, 5, 0],
    "multiplexed_loader_rejects_sync":
        "@serve.multiplexed requires an async def loader",
}


def _run(pkg, case, monkeypatch):
    # The reference lowers a stable replica set onto its compiled route,
    # which the port does not have: both packages take the dynamic path.
    monkeypatch.setenv("RAY_TPU_SERVE_COMPILED", "0")
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
def test_port_multiplex_matches_reference(case, monkeypatch):
    with gc_paused():
        ref = _run(ray_tpu, case, monkeypatch)
    port = _run(ray_tpu_torch, case, monkeypatch)  # the collector on
    assert ref == EXPECTED[case.__name__]
    assert port == ref


@pytest.mark.parametrize("case", LOCAL_CASES,
                         ids=[c.__name__ for c in LOCAL_CASES])
def test_port_multiplex_wrapper_matches_reference(case):
    ref = case(ray_tpu)
    port = case(ray_tpu_torch)
    assert ref == EXPECTED[case.__name__]
    assert port == ref


def test_handle_options_carry_the_model_id():
    """The id rides on the handle (and its pickle) and reaches the router
    and the replica as a keyword the replica pops."""
    import pickle

    from ray_tpu_torch.serve.handle import DeploymentHandle

    h = DeploymentHandle("D", "app")
    h._router = object()  # no runtime: options() shares the router
    m = h.options(multiplexed_model_id="m1")
    assert m._multiplexed_model_id == "m1"
    assert m.options(method_name="f")._multiplexed_model_id == "m1"
    assert m.options(multiplexed_model_id="")._multiplexed_model_id == ""
    assert pickle.loads(pickle.dumps(m))._multiplexed_model_id == "m1"
    assert h._multiplexed_model_id == ""


def test_router_prefers_warm_replicas_with_a_spare_slot():
    from ray_tpu_torch.serve.router import PowerOfTwoChoicesReplicaScheduler

    sched = PowerOfTwoChoicesReplicaScheduler()
    sched.update_replicas([
        {"replica_id": "a", "max_ongoing_requests": 2,
         "multiplexed_model_ids": ["m1"]},
        {"replica_id": "b", "max_ongoing_requests": 2,
         "multiplexed_model_ids": ["m2"]},
        {"replica_id": "c", "max_ongoing_requests": 2,
         "multiplexed_model_ids": ["m1", "m2"]}])
    for _ in range(20):
        assert sched.choose_replica("m2")["replica_id"] in ("b", "c")
    sched.on_request_sent("c")
    sched.on_request_sent("c")  # c is full: b is the only warm pick
    assert {sched.choose_replica("m2")["replica_id"]
            for _ in range(20)} == {"b"}
    sched.on_request_sent("b")
    sched.on_request_sent("b")  # no warm replica has a slot: the pick
    # falls back to two choices over every replica, a free one first.
    assert "a" in {sched.choose_replica("m2")["replica_id"]
                   for _ in range(50)}
    assert "a" in {sched.choose_replica("m9")["replica_id"]
                   for _ in range(50)}


# ------------------------------------------------ GPT2MultiplexNext on the CPU
_FIELDS = dict(vocab_size=512, n_layer=2, n_head=2, d_model=128, seq_len=64,
               dtype=torch.float32, logits_dtype=torch.float32)


def _config():
    from ray_tpu_torch.models import gpt2

    return gpt2.GPTConfig(**_FIELDS)


def _tokens(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(k)).tolist()
            for k in rng.integers(1, 65, n)]


def _close_to(single, seed, tokens, answer):
    logits = single[seed].logits(tokens)
    return bool(logits[answer] >= logits.max() - 1e-5)


def test_gpt2_multiplex_in_process_evicts_and_batches_per_model():
    from ray_tpu_torch.serve import (GPT2MultiplexNext, GPT2Next, batching,
                                     context)

    cfg = _config()
    single = {s: GPT2Next(cfg, seed=s, device="cpu") for s in (1, 2, 3)}
    replica = GPT2MultiplexNext(cfg, device="cpu",
                                max_num_models_per_replica=2)
    reqs = _tokens(9, seed=0)

    async def ask(model_id, toks):
        context._set_request_model_id(model_id)
        return (await replica({"tokens": toks}))["next_token"]

    async def main():
        first = weakref.ref(await replica.get_model("seed-1"))
        answers = await asyncio.gather(*[
            ask(f"seed-{1 + i % 2}", t) for i, t in enumerate(reqs[:6])])
        third = await ask("seed-3", reqs[6])  # evicts seed-1, the LRU
        (wrapper,) = replica.get_model._multiplex_wrappers.values()
        return first, answers, third, wrapper.loaded_model_ids

    tags = {"deployment": "", "method": "next_token"}
    before = batching.BATCH_SIZE_HISTOGRAM.get(tags=tags)
    first, answers, third, loaded = asyncio.run(main())
    after = batching.BATCH_SIZE_HISTOGRAM.get(tags=tags)
    for i, (toks, ans) in enumerate(zip(reqs, answers)):
        assert _close_to(single, 1 + i % 2, toks, ans)
    assert _close_to(single, 3, reqs[6], third)
    assert loaded == ["seed-2", "seed-3"]
    gc.collect()
    assert first() is None  # nothing holds the evicted weights
    # One batch per model id, never mixed (3 + 3), then seed-3 alone.
    assert after["count"] - before["count"] == 3
    assert after["sum"] - before["sum"] == 7
    assert [b - a for a, b in zip(before["counts"], after["counts"])][:3] \
        == [1, 0, 2]  # one batch of 1, two of 3 (the bucket up to 4)


def test_gpt2_multiplex_evicts_a_model_a_batch_is_running_on(monkeypatch):
    """One replica holding one model at a time, requests for two: the
    first model's forward waits, between its blocks and its LM head, until
    the second model's requests, sent only then, have evicted its weights.
    The running batch keeps them and every request is answered."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import GPT2MultiplexNext, GPT2Next, context

    cfg = _config()
    single = {s: GPT2Next(cfg, seed=s, device="cpu") for s in (1, 2)}
    reqs = _tokens(6, seed=7)
    models = {}
    paused = []
    forwards = itertools.count()  # next() is atomic: one forward is first
    waiting = threading.Event()

    class Replica(GPT2MultiplexNext):
        async def _load(self, model_id):
            models[model_id] = await super()._load(model_id)
            return models[model_id]

    replica = Replica(cfg, device="cpu", max_num_models_per_replica=1)
    forward_hidden = gpt2.forward_hidden

    def resident(params):
        (wrapper,) = replica.get_model._multiplex_wrappers.values()
        return [m for m in wrapper.loaded_model_ids
                if models[m].params is params]

    def paused_forward(params, tokens, config):
        first = next(forwards) == 0
        x = forward_hidden(params, tokens, config)
        if first:
            waiting.set()
            deadline = time.time() + 30
            while resident(params) and time.time() < deadline:
                time.sleep(0.01)
            paused.append(resident(params))
        return x

    monkeypatch.setattr(gpt2, "forward_hidden", paused_forward)

    async def ask(model_id, toks):
        context._set_request_model_id(model_id)
        return (await replica({"tokens": toks}))["next_token"]

    async def main():
        ones = [asyncio.ensure_future(ask("seed-1", t)) for t in reqs[0::2]]
        deadline = time.time() + 30
        while not waiting.is_set() and time.time() < deadline:
            await asyncio.sleep(0.01)
        twos = [ask("seed-2", t) for t in reqs[1::2]]
        ones, twos = await asyncio.gather(asyncio.gather(*ones),
                                          asyncio.gather(*twos))
        return [a for pair in zip(ones, twos) for a in pair]

    answers = asyncio.run(main())
    # The paused forward went on to its LM head on evicted weights.
    assert paused == [[]]
    for i, (toks, ans) in enumerate(zip(reqs, answers)):
        assert _close_to(single, 1 + i % 2, toks, ans)


@pytest.mark.parametrize("model_id,error", [
    ("", ValueError), ("seed-x", ValueError), ("llama", ValueError)])
def test_gpt2_multiplex_rejects_bad_model_ids(model_id, error):
    from ray_tpu_torch.serve import GPT2MultiplexNext, context

    replica = GPT2MultiplexNext(_config(), device="cpu")

    async def main():
        context._set_request_model_id(model_id)
        return await replica({"tokens": [1, 2]})

    with pytest.raises(error):
        asyncio.run(main())


def test_gpt2_multiplex_batch_refuses_a_stray_model_id():
    from ray_tpu_torch.serve import GPT2MultiplexNext, context

    replica = GPT2MultiplexNext(_config(), device="cpu")

    async def main():
        context._set_request_model_id("seed-1")
        return await replica.next_token(("seed-2", [1, 2]))

    with pytest.raises(RuntimeError, match="holds requests for"):
        asyncio.run(main())


def test_gpt2_multiplex_served_warm_across_two_replicas():
    """Through serve.run and the handle: answers equal GPT2Next built from
    each seed, and once the router knows where each model lives, the
    alternating traffic loads nothing."""
    from ray_tpu_torch.serve import GPT2MultiplexNext, GPT2Next, multiplex

    cfg = _config()
    single = {s: GPT2Next(cfg, seed=s, device="cpu") for s in (1, 2)}
    reqs = _tokens(8, seed=5)

    def loads():
        return sum(v for _, _, v in multiplex.MODEL_LOADS.samples())

    fresh_init(ray_tpu_torch, num_cpus=8)
    serve = ray_tpu_torch.serve
    try:
        handle = serve.run(
            serve.deployment(num_replicas=2)(GPT2MultiplexNext).bind(
                cfg, device="cpu", max_num_models_per_replica=1),
            name="gpt2mux", route_prefix=None)
        hs = {s: handle.options(multiplexed_model_id=f"seed-{s}")
              for s in (1, 2)}
        pair = [hs[1].remote({"tokens": reqs[0]}),
                hs[2].remote({"tokens": reqs[1]})]
        answers = [r.result(timeout_s=60)["next_token"] for r in pair]
        assert _wait(lambda: sorted(map(tuple, _router_view(handle).values()))
                     == [("seed-1",), ("seed-2",)])
        before = loads()
        for i, toks in enumerate(reqs[2:], start=2):
            answers.append(hs[1 + i % 2].remote({"tokens": toks}).result(
                timeout_s=60)["next_token"])
        assert loads() == before
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    for i, (toks, ans) in enumerate(zip(reqs, answers)):
        assert _close_to(single, 1 + i % 2, toks, ans)
