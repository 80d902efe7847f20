"""The port's ``@serve.batch`` and ``@serve.continuous_batch``
(ray_tpu_torch.serve.batching, .continuous) against the reference
(ray_tpu.serve), on the cases of tests/test_serve_batching.py, and the
port's batched GPT-2 replicas (``GPT2BatchNext``, ``GPT2ContinuousStream``)
against reference twins built here from ``ray_tpu.serve.batch`` /
``continuous_batch`` around the JAX ``gpt2.forward`` with the same weights.

Each parity case is one body run on ``ray_tpu`` and then on
``ray_tpu_torch`` (never both at once), and the observations must be
equal. The decorators run on a plain asyncio loop, as in the reference's
tests: no runtime is started, so nothing here pauses the collector.
"""

import asyncio
import importlib
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.serve  # noqa: F401 — registers the reference's modules
import ray_tpu_torch.serve  # noqa: F401
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.serve import GPT2BatchNext, GPT2ContinuousStream, GPT2Next

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.serve.{name}")


# ------------------------------------------------------------- @serve.batch
def coalesces_concurrent_calls(pkg):
    calls = []

    @_mod(pkg, "batching").batch(max_batch_size=8, batch_wait_timeout_s=0.2)
    async def double(items):
        calls.append(len(items))
        return [x * 2 for x in items]

    async def main():
        return await asyncio.gather(*[double(i) for i in range(8)])

    return [asyncio.run(main()), calls]


def sync_function_supported(pkg):
    @_mod(pkg, "batching").batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    def add_one(items):
        return [x + 1 for x in items]

    async def main():
        return await asyncio.gather(*[add_one(i) for i in range(4)])

    return asyncio.run(main())


def per_request_error_isolation(pkg):
    @_mod(pkg, "batching").batch(max_batch_size=8, batch_wait_timeout_s=0.1)
    async def picky(items):
        return [ValueError(f"bad {x}") if x == 2 else x for x in items]

    async def main():
        return await asyncio.gather(*[picky(i) for i in range(4)],
                                    return_exceptions=True)

    return [repr(x) for x in asyncio.run(main())]


def wrong_length_fails_whole_batch(pkg):
    @_mod(pkg, "batching").batch(max_batch_size=4, batch_wait_timeout_s=0.1)
    async def broken(items):
        return items[:-1]

    async def main():
        return await asyncio.gather(*[broken(i) for i in range(3)],
                                    return_exceptions=True)

    return [(type(e).__name__, str(e)) for e in asyncio.run(main())]


def timeout_flushes_partial_batch(pkg):
    @_mod(pkg, "batching").batch(max_batch_size=64, batch_wait_timeout_s=0.05,
                                 adaptive=False)
    async def echo(items):
        return list(items)

    async def main():
        t0 = time.monotonic()
        out = await echo("solo")
        return out, time.monotonic() - t0

    out, elapsed = asyncio.run(main())
    return [out, elapsed < 2.0]


def adaptive_timeout_shrinks_under_load_and_recovers(pkg):
    seen = []

    async def main():
        async def noop(items):
            return list(items)

        cfg = {"max_batch_size": 4, "batch_wait_timeout_s": 0.08,
               "adaptive": True}
        q = _mod(pkg, "batching")._BatchQueue(noop, None, cfg)
        seen.append(q.effective_timeout_s)
        for n in [4] * 8 + [1] * 12 + [3]:
            q._adapt(n, 4)
            seen.append(q.effective_timeout_s)
        q._task.cancel()

    asyncio.run(main())
    return seen


def queues_keyed_by_model_id(pkg):
    context = _mod(pkg, "context")
    seen = []

    @_mod(pkg, "batching").batch(max_batch_size=8, batch_wait_timeout_s=0.05)
    async def infer(items):
        seen.append((context.get_multiplexed_model_id(), sorted(items)))
        return list(items)

    async def call_with_model(model_id, x):
        context._set_request_model_id(model_id)
        return await infer(x)

    async def main():
        return await asyncio.gather(
            *[call_with_model("m1", f"a{i}") for i in range(3)],
            *[call_with_model("m2", f"b{i}") for i in range(3)])

    out = asyncio.run(main())
    queues = sorted(q.model_id for q in infer._batch_queues.values())
    return [out, sorted(seen), queues]


def rejects_generators_and_bad_signatures(pkg):
    batch = _mod(pkg, "batching").batch
    out = []
    try:
        @batch
        def gen(items):
            yield items
    except TypeError as e:
        out.append(str(e))

    @batch(max_batch_size=2, batch_wait_timeout_s=0.01)
    async def one_arg(item):
        return [item]

    async def main():
        await one_arg(x=1)

    try:
        asyncio.run(main())
    except TypeError as e:
        out.append(str(e))
    for kwargs in (dict(max_batch_size=0), dict(batch_wait_timeout_s=-1)):
        try:
            batch(**kwargs)(one_arg)
        except ValueError as e:
            out.append(str(e))
    return out


def runtime_reconfiguration(pkg):
    @_mod(pkg, "batching").batch(max_batch_size=2, batch_wait_timeout_s=0.01)
    async def f(items):
        return list(items)

    f.set_max_batch_size(16)
    f.set_batch_wait_timeout_s(0.5)
    fused = _mod(pkg, "batching").batch_fusion(f)
    return [dict(f._batch_config), fused[1] is f._batch_config,
            _mod(pkg, "batching").batch_fusion(lambda x: x)]


# -------------------------------------------------- @serve.continuous_batch
def continuous_streams_and_shares_steps(pkg):
    cont = _mod(pkg, "continuous")
    step_sizes = []

    @cont.continuous_batch(max_batch_size=8)
    def steps(slots):
        step_sizes.append(len(slots))
        outs = []
        for s in slots:
            i = s.state.setdefault("i", 0)
            s.state["i"] = i + 1
            outs.append(cont.EOS if i >= s.request else f"t{i}")
        return outs

    async def consume(n):
        return [item async for item in steps(n)]

    async def main():
        return await asyncio.gather(consume(3), consume(5), consume(1))

    out = asyncio.run(main())
    return [out, len(step_sizes) <= 9, max(step_sizes) >= 2]


def continuous_admits_mid_flight(pkg):
    cont = _mod(pkg, "continuous")
    admitted_with = []

    @cont.continuous_batch(max_batch_size=8)
    async def steps(slots):
        admitted_with.append({s.request for s in slots})
        await asyncio.sleep(0.01)
        outs = []
        for s in slots:
            i = s.state.setdefault("i", 0)
            s.state["i"] = i + 1
            outs.append(cont.EOS if i >= 20 else i)
        return outs

    async def main():
        async def first():
            return [x async for x in steps("A")]

        async def late():
            await asyncio.sleep(0.06)
            return [x async for x in steps("B")]

        return await asyncio.gather(first(), late())

    a, b = asyncio.run(main())
    return [a, b, {"A", "B"} in admitted_with, admitted_with[0] == {"A"}]


def continuous_retires_without_stalling_others(pkg):
    cont = _mod(pkg, "continuous")

    @cont.continuous_batch(max_batch_size=4)
    def steps(slots):
        outs = []
        for s in slots:
            i = s.state.setdefault("i", 0)
            s.state["i"] = i + 1
            outs.append(cont.EOS if i >= s.request else i)
        return outs

    async def main():
        short = [x async for x in steps(2)]
        long = [x async for x in steps(4)]
        return short, long

    return list(asyncio.run(main()))


def continuous_per_stream_error_isolation(pkg):
    cont = _mod(pkg, "continuous")

    @cont.continuous_batch(max_batch_size=4)
    def steps(slots):
        outs = []
        for s in slots:
            i = s.state.setdefault("i", 0)
            s.state["i"] = i + 1
            if s.request == "bad" and i == 1:
                outs.append(RuntimeError("sequence exploded"))
            elif s.request == "burst" and i == 0:
                outs.append(cont.Emissions(["x", "y"], eos=True))
            else:
                outs.append(cont.EOS if i >= 3 else i)
        return outs

    async def consume(req):
        try:
            return [x async for x in steps(req)]
        except RuntimeError as e:
            return repr(e)

    async def main():
        return await asyncio.gather(consume("good"), consume("bad"),
                                    consume("burst"))

    return list(asyncio.run(main()))


def continuous_rejects_generator_step(pkg):
    cont = _mod(pkg, "continuous")
    out = []
    for bad in ({}, {"max_batch_size": 0}):
        try:
            @cont.continuous_batch(**bad)
            def gen(slots):
                yield slots
        except (TypeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return [out, repr(cont.EOS)]


def continuous_cancelled_consumer_retires_slot(pkg):
    cont = _mod(pkg, "continuous")
    steps_run = []

    @cont.continuous_batch(max_batch_size=4)
    def steps(slots):
        steps_run.append(len(slots))
        outs = []
        for s in slots:
            i = s.state.setdefault("i", 0)
            s.state["i"] = i + 1
            outs.append(i)  # endless
        return outs

    async def main():
        agen = steps("x")
        first = await agen.__anext__()
        await agen.aclose()  # consumer disconnects
        await asyncio.sleep(0.05)
        after_close = len(steps_run)
        await asyncio.sleep(0.1)
        (engine,) = steps._continuous_engines.values()
        return [first, engine._admit.qsize(), len(steps_run) == after_close]

    return asyncio.run(main())


CASES = [
    coalesces_concurrent_calls, sync_function_supported,
    per_request_error_isolation, wrong_length_fails_whole_batch,
    timeout_flushes_partial_batch,
    adaptive_timeout_shrinks_under_load_and_recovers,
    queues_keyed_by_model_id, rejects_generators_and_bad_signatures,
    runtime_reconfiguration,
    continuous_streams_and_shares_steps, continuous_admits_mid_flight,
    continuous_retires_without_stalling_others,
    continuous_per_stream_error_isolation,
    continuous_rejects_generator_step,
    continuous_cancelled_consumer_retires_slot,
]

#: The reference's own assertions (tests/test_serve_batching.py), so that
#: two equal observations are also the right ones.
EXPECTED = {
    "coalesces_concurrent_calls": [[0, 2, 4, 6, 8, 10, 12, 14], [8]],
    "sync_function_supported": [1, 2, 3, 4],
    "per_request_error_isolation": ["0", "1", "ValueError('bad 2')", "3"],
    "timeout_flushes_partial_batch": ["solo", True],
    "adaptive_timeout_shrinks_under_load_and_recovers": [
        0.08, 0.04, 0.02, 0.01, 0.005, 0.0025, 0.00125, 0.0, 0.0,
        0.0025, 0.005, 0.01, 0.02, 0.04, 0.08, 0.08, 0.08, 0.08, 0.08,
        0.08, 0.08, 0.08],
    "queues_keyed_by_model_id": [
        ["a0", "a1", "a2", "b0", "b1", "b2"],
        [("m1", ["a0", "a1", "a2"]), ("m2", ["b0", "b1", "b2"])],
        ["m1", "m2"]],
    "runtime_reconfiguration": [
        {"max_batch_size": 16, "batch_wait_timeout_s": 0.5,
         "adaptive": True}, True, None],
    "continuous_streams_and_shares_steps": [
        [["t0", "t1", "t2"], ["t0", "t1", "t2", "t3", "t4"], ["t0"]],
        True, True],
    "continuous_admits_mid_flight": [list(range(20)), list(range(20)), True,
                                     True],
    "continuous_retires_without_stalling_others": [[0, 1], [0, 1, 2, 3]],
    "continuous_per_stream_error_isolation": [
        [0, 1, 2], "RuntimeError('sequence exploded')", ["x", "y"]],
    "continuous_cancelled_consumer_retires_slot": [0, 0, True],
}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_port_batching_matches_reference(case):
    ref = case("ray_tpu")
    port = case("ray_tpu_torch")
    if case.__name__ in EXPECTED:
        assert ref == EXPECTED[case.__name__]
    assert port == ref


@pytest.mark.parametrize("name,module", [
    ("batch", "batching"), ("continuous_batch", "continuous"),
    ("EOS", "continuous"), ("Emissions", "continuous"),
    ("SequenceSlot", "continuous"), ("multiplexed", "multiplex"),
    ("get_multiplexed_model_id", "context")])
def test_exports_match_the_reference(name, module):
    for pkg in PACKAGES:
        serve = importlib.import_module(pkg + ".serve")
        assert name in serve.__all__
        assert getattr(serve, name) is getattr(_mod(pkg, module), name)


def test_batch_records_queue_wait_and_batch_size_series():
    """The two series and the queue-wait histogram record every vectorized
    call (here without a replica: empty deployment tag)."""
    from ray_tpu_torch.serve import batching, metrics

    tags = {"deployment": "", "method": "twice"}
    before = batching.BATCH_SIZE_HISTOGRAM.get(tags=tags)
    waits = metrics.QUEUE_WAIT.get(tags=tags)

    @batching.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    async def twice(items):
        return [2 * x for x in items]

    async def main():
        return await asyncio.gather(*[twice(i) for i in range(6)])

    assert asyncio.run(main()) == [0, 2, 4, 6, 8, 10]
    after = batching.BATCH_SIZE_HISTOGRAM.get(tags=tags)
    assert after["count"] - before["count"] == 2  # 4 + 2
    assert after["sum"] - before["sum"] == 6
    assert metrics.QUEUE_WAIT.get(tags=tags)["count"] - waits["count"] == 6
    from ray_tpu_torch.util import metrics as util_metrics

    text = util_metrics.registry().prometheus_text()
    assert "serve_batch_size" in text and "serve_batch_queue_depth" in text


def test_batch_spans_follow_each_request_when_tracing():
    from ray_tpu_torch.serve import batching
    from ray_tpu_torch.util import tracing

    @batching.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    async def echo(items):
        return list(items)

    async def traced(i):
        with tracing.span("client"):
            return await echo(i)

    async def main():
        return await asyncio.gather(*[traced(i) for i in range(3)])

    tracing.enable_tracing()
    tracing.clear_spans()
    try:
        assert asyncio.run(main()) == [0, 1, 2]
        spans = tracing.exported_spans()
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()
    clients = {s["span_id"]: s for s in spans if s["name"] == "client"}
    for name in ("serve.queue_wait", "serve.batch_execute"):
        mine = [s for s in spans if s["name"] == name]
        assert len(mine) == 3
        assert {s["parent_id"] for s in mine} == set(clients)
        assert all(s["attributes"]["batch_size"] == 3 for s in mine)


# ------------------------------------------------- the batched GPT-2 bodies
_FIELDS = dict(vocab_size=512, n_layer=2, n_head=2, d_model=128, seq_len=64,
               attn_block_q=128, attn_block_kv=128)
_TIE_TOL = 1e-4  # fp32 on both sides


@pytest.fixture(scope="module")
def setup():
    jcfg = jgpt2.GPTConfig(dtype=jnp.float32, logits_dtype=jnp.float32,
                           attn_impl="xla", **_FIELDS)
    tcfg = tgpt2.GPTConfig(dtype=torch.float32, logits_dtype=torch.float32,
                           attn_impl="auto", **_FIELDS)
    jparams = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.key(0)))
    tparams = convert.params_from_numpy(jparams, device="cpu")
    fwd = jax.jit(lambda p, t: jgpt2.forward(p, t, jcfg))
    return jcfg, tcfg, jparams, tparams, fwd


def _near_tie(chosen, ref_logits):
    return ref_logits[chosen] >= ref_logits.max() - _TIE_TOL


def _ref_logits(fwd, params, tokens, seq_len=64):
    """The JAX model's logits after ``tokens``, padded to seq_len (one
    compiled shape; causal attention keeps the padding out)."""
    arr = np.zeros((1, seq_len), np.int32)
    arr[0, :len(tokens)] = tokens
    return np.asarray(fwd(params, jnp.asarray(arr)))[0, len(tokens) - 1]


class _RefBatchNext:
    """The reference's ``serve.batch`` around the JAX forward: one forward
    over the batch right-padded to its longest request."""

    def __init__(self, fwd, params):
        self._fwd, self.params = fwd, params
        self.batch_sizes = []

    @ray_tpu.serve.batch(max_batch_size=32, batch_wait_timeout_s=0.01)
    def next_token(self, token_lists):
        arr = np.zeros((len(token_lists), max(map(len, token_lists))),
                       np.int32)
        for row, toks in enumerate(token_lists):
            arr[row, :len(toks)] = toks
        logits = np.asarray(self._fwd(self.params, jnp.asarray(arr)))
        self.batch_sizes.append(len(token_lists))
        return [int(np.argmax(logits[row, len(toks) - 1]))
                for row, toks in enumerate(token_lists)]


class _RefContinuousStream:
    """The reference's ``serve.continuous_batch`` around the JAX forward:
    every step pads each live stream to seq_len; the last token ends its
    stream in the same step."""

    def __init__(self, fwd, params, seq_len):
        self._fwd, self.params, self.seq_len = fwd, params, seq_len
        self.batch_sizes = []

    @ray_tpu.serve.continuous_batch(max_batch_size=32)
    def __call__(self, slots):
        for s in slots:
            if "tokens" not in s.state:
                s.state["tokens"], s.state["left"] = list(s.request[0]), \
                    s.request[1]
        live = [s for s in slots if s.state["left"] > 0]
        outs = {id(s): ray_tpu.serve.EOS for s in slots}
        if live:
            arr = np.zeros((len(live), self.seq_len), np.int32)
            for row, s in enumerate(live):
                arr[row, :len(s.state["tokens"])] = s.state["tokens"]
            logits = np.asarray(self._fwd(self.params, jnp.asarray(arr)))
            self.batch_sizes.append(len(live))
            for row, s in enumerate(live):
                tok = int(np.argmax(logits[row, len(s.state["tokens"]) - 1]))
                s.state["tokens"].append(tok)
                s.state["left"] -= 1
                item = json.dumps({"token": tok})
                outs[id(s)] = (ray_tpu.serve.Emissions([item], eos=True)
                               if s.state["left"] == 0 else item)
        return [outs[id(s)] for s in slots]


class _LoggedBatchNext(GPT2BatchNext):
    """``GPT2BatchNext`` that keeps the size of every vectorized call."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_sizes = []

    def next_tokens(self, token_lists):
        self.batch_sizes.append(len(token_lists))
        return super().next_tokens(token_lists)


class _LoggedContinuousStream(GPT2ContinuousStream):
    """``GPT2ContinuousStream`` that keeps the streams each forward
    stepped."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_sizes = []

    def logits_rows(self, tokens, positions):
        self.batch_sizes.append(len(positions))
        return super().logits_rows(tokens, positions)


class _Request:
    def __init__(self, body=None, query_params=None):
        self._body = body
        self.query_params = query_params or {}

    async def json(self):
        return self._body


def _requests(n, seed=0, low=1, high=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(length)).tolist()
            for length in rng.integers(low, high + 1, n)]


def test_batched_logits_equal_the_single_request_ones(setup):
    """One padded forward over the batch gives each request's logits as
    its own B=1 forward does."""
    _, tcfg, _, tparams, _ = setup
    reqs = _requests(12, seed=1) + [list(range(64)), [7]]
    replica = GPT2BatchNext(tcfg, device="cpu", params=tparams)
    single = GPT2Next(tcfg, device="cpu", params=tparams)
    arr = np.zeros((len(reqs), 64), np.int64)
    for row, toks in enumerate(reqs):
        arr[row, :len(toks)] = toks
    batched = replica.logits_rows(arr, [len(t) - 1 for t in reqs])
    ones = torch.stack([single.logits(t) for t in reqs])
    assert batched.shape == (len(reqs), 512) and batched.dtype == torch.float32
    torch.testing.assert_close(batched, ones, rtol=0, atol=1e-5)
    # Padded only to the longest of the batch, the same again.
    short = reqs[:3]
    arr = np.zeros((3, max(map(len, short))), np.int64)
    for row, toks in enumerate(short):
        arr[row, :len(toks)] = toks
    torch.testing.assert_close(
        replica.logits_rows(arr, [len(t) - 1 for t in short]), ones[:3],
        rtol=0, atol=1e-5)


def test_batch_next_matches_the_reference_twin(setup):
    from ray_tpu_torch.serve import batching

    jcfg, tcfg, jparams, tparams, fwd = setup
    reqs = _requests(40, seed=2)
    replica = _LoggedBatchNext(tcfg, device="cpu", params=tparams)
    twin = _RefBatchNext(fwd, jparams)

    async def port():
        return await asyncio.gather(*[
            replica(_Request(body={"tokens": t})) for t in reqs])

    async def ref():
        return await asyncio.gather(*[twin.next_token(t) for t in reqs])

    ref_answers = asyncio.run(ref())
    tags = {"deployment": "", "method": "next_token"}
    before = batching.BATCH_SIZE_HISTOGRAM.get(tags=tags)
    answers = asyncio.run(port())
    after = batching.BATCH_SIZE_HISTOGRAM.get(tags=tags)
    assert all(set(a) == {"next_token"} for a in answers)
    # Forty requests queued at once: a full batch of 32, then the rest.
    assert replica.batch_sizes == twin.batch_sizes == [32, 8]
    # serve_batch_size saw the same: one observation per vectorized call,
    # their sum the requests.
    assert after["count"] - before["count"] == 2
    assert after["sum"] - before["sum"] == 40
    for toks, ans, ref_ans in zip(reqs, answers, ref_answers):
        logits = _ref_logits(fwd, jparams, toks)
        assert _near_tie(ans["next_token"], logits)
        assert _near_tie(ref_ans, logits)


def test_batch_next_rejects_a_bad_request_alone(setup):
    _, tcfg, _, tparams, _ = setup
    replica = _LoggedBatchNext(tcfg, device="cpu", params=tparams)

    async def main():
        return await asyncio.gather(
            replica(_Request(body={"tokens": [1, 2]})),
            replica(_Request(body={"tokens": [512]})),
            replica(_Request(body={"tokens": []})),
            replica(_Request(body={"tokens": [3]})),
            return_exceptions=True)

    good, bad, empty, other = asyncio.run(main())
    assert isinstance(bad, ValueError) and isinstance(empty, ValueError)
    single = GPT2Next(tcfg, device="cpu", params=tparams)
    assert good == {"next_token": single.next_token([1, 2])}
    assert other == {"next_token": single.next_token([3])}
    assert replica.batch_sizes == [2]


def _stream_query(prompt, max_new):
    return _Request(query_params={"tokens": ",".join(map(str, prompt)),
                                  "max_new": str(max_new)})


def test_continuous_stream_matches_the_reference_twin(setup):
    """Streams of different lengths, two of them admitted mid-flight: each
    port token is the reference's greedy choice at that stream's own
    prefix, and both engines step the same streams together."""
    jcfg, tcfg, jparams, tparams, fwd = setup
    prompts = _requests(5, seed=3, high=40)
    max_new = [6, 3, 8, 1, 5]
    replica = _LoggedContinuousStream(tcfg, device="cpu", params=tparams)
    twin = _RefContinuousStream(fwd, jparams, tcfg.seq_len)

    async def drive(call):
        first_token = asyncio.Event()

        async def consume(i, late):
            if late:
                await first_token.wait()
            out = []
            async for item in call(i):
                out.append(item)
                first_token.set()
            return out

        return await asyncio.gather(*[consume(i, i >= 3)
                                      for i in range(len(prompts))])

    port = asyncio.run(drive(
        lambda i: replica(_stream_query(prompts[i], max_new[i]))))
    ref = asyncio.run(drive(lambda i: twin((prompts[i], max_new[i]))))
    for prompt, n, chunks, ref_chunks in zip(prompts, max_new, port, ref):
        assert len(chunks) == len(ref_chunks) == n
        seq = list(prompt)
        for chunk in chunks:
            tok = json.loads(chunk)["token"]
            assert _near_tie(tok, _ref_logits(fwd, jparams, seq))
            seq.append(tok)
    # Both engines start with the three first streams, admit the late two
    # mid-flight, share steps, and step each stream once per token.
    for sizes in (replica.batch_sizes, twin.batch_sizes):
        assert sizes[0] == 3 and max(sizes) > 3
        assert sum(sizes) == sum(max_new) and len(sizes) < sum(max_new)


def test_continuous_stream_errors_only_the_bad_stream(setup):
    _, tcfg, _, tparams, _ = setup
    replica = GPT2ContinuousStream(tcfg, device="cpu", params=tparams)

    async def consume(req):
        try:
            return [json.loads(c)["token"] async for c in replica(req)]
        except ValueError as e:
            return e

    async def main():
        return await asyncio.gather(
            consume(_stream_query([1, 2, 3], 4)),
            consume(_stream_query(list(range(60)), 6)),  # 60 + 5 > seq_len
            consume(_stream_query([1, 2, 3], 0)),
            consume(_Request()))  # the example's defaults: 1,2,3 and 8

    good, too_long, none, defaults = asyncio.run(main())
    assert isinstance(too_long, ValueError)
    assert none == []
    assert len(good) == 4 and len(defaults) == 8
    assert defaults[:4] == good
