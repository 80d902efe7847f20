"""The port's GPT-2 replicas (ray_tpu_torch.serve) against the reference
replica bodies of examples/serve_gpt2.py, rebuilt here around the JAX
``gpt2.forward`` with the same weights.

Random-init logits are near-flat, so a chosen token is held to the rule
that its reference logit lies within a tolerance of the reference maximum,
rather than to exact argmax equality.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.serve import GPT2Next, GPT2Stream

_FIELDS = dict(vocab_size=512, n_layer=2, n_head=2, d_model=128, seq_len=64,
               attn_block_q=128, attn_block_kv=128)
_TIE_TOL = 1e-4  # fp32 on both sides


class _Request:
    def __init__(self, body=None, query_params=None):
        self._body = body
        self.query_params = query_params or {}

    async def json(self):
        return self._body


class _RefNext:
    """examples/serve_gpt2.py:GPT2Next's body, returning the logits too."""

    def __init__(self, config, params):
        self.params = params
        self._fwd = jax.jit(lambda p, t: jgpt2.forward(p, t, config))

    def __call__(self, tokens):
        tokens = np.asarray(tokens, np.int32)[None, :]
        logits = np.asarray(self._fwd(self.params, jnp.asarray(tokens)))
        return int(np.argmax(logits[0, -1])), logits[0, -1]


class _RefStream:
    """examples/serve_gpt2.py:GPT2Stream's step: pad to seq_len, read the
    logits at the last real position."""

    def __init__(self, config, params):
        self.config, self.params = config, params
        self._fwd = jax.jit(lambda p, t: jgpt2.forward(p, t, config))

    def step_logits(self, tokens):
        arr = np.zeros((1, self.config.seq_len), np.int32)
        arr[0, :len(tokens)] = tokens
        return np.asarray(self._fwd(self.params, jnp.asarray(arr)))[
            0, len(tokens) - 1]


@pytest.fixture(scope="module")
def setup():
    jcfg = jgpt2.GPTConfig(dtype=jnp.float32, logits_dtype=jnp.float32,
                           attn_impl="xla", **_FIELDS)
    tcfg = tgpt2.GPTConfig(dtype=torch.float32, logits_dtype=torch.float32,
                           attn_impl="auto", **_FIELDS)
    jparams = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.key(0)))
    tparams = convert.params_from_numpy(jparams, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _near_tie(chosen, ref_logits):
    return ref_logits[chosen] >= ref_logits.max() - _TIE_TOL


@pytest.mark.parametrize("length", [1, 4, 33, 64])
def test_next_matches_reference(setup, length):
    jcfg, tcfg, jparams, tparams = setup
    toks = np.random.default_rng(length).integers(0, 512, length).tolist()
    replica = GPT2Next(tcfg, device="cpu", params=tparams)
    out = asyncio.run(replica(_Request(body={"tokens": toks})))
    assert set(out) == {"next_token"} and isinstance(out["next_token"], int)
    _, ref_logits = _RefNext(jcfg, jparams)(toks)
    assert _near_tie(out["next_token"], ref_logits)
    np.testing.assert_allclose(replica.logits(toks).numpy(), ref_logits,
                               rtol=1e-4, atol=1e-4)


def test_stream_matches_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    prompt = np.random.default_rng(7).integers(0, 512, 20).tolist()
    replica = GPT2Stream(tcfg, device="cpu", params=tparams)
    chunks = list(replica(_Request(query_params={
        "tokens": ",".join(map(str, prompt)), "max_new": "6"})))
    streamed = [json.loads(c)["token"] for c in chunks]
    assert len(streamed) == 6
    ref = _RefStream(jcfg, jparams)
    seq = list(prompt)
    for tok in streamed:  # the reference along the port's own trajectory
        assert _near_tie(tok, ref.step_logits(seq))
        seq.append(tok)


def test_stream_defaults_follow_the_example(setup):
    _, tcfg, _, tparams = setup
    replica = GPT2Stream(tcfg, device="cpu", params=tparams)
    chunks = list(replica(_Request()))
    assert len(chunks) == 8
    assert list(replica.generate([1, 2, 3], 8)) == [
        json.loads(c)["token"] for c in chunks]


@pytest.mark.parametrize("tokens,max_new", [
    (list(range(65)), 1), (list(range(60)), 6), ([], 1), ([1, 512], 1),
    ([-1], 1)])
def test_bad_requests_raise(setup, tokens, max_new):
    _, tcfg, _, tparams = setup
    with pytest.raises(ValueError):
        list(GPT2Stream(tcfg, device="cpu", params=tparams).generate(
            tokens, max_new))
    if max_new == 1:
        with pytest.raises(ValueError):
            GPT2Next(tcfg, device="cpu", params=tparams).next_token(tokens)


def test_full_sequence_is_allowed(setup):
    _, tcfg, _, tparams = setup
    toks = list(range(64))
    assert isinstance(GPT2Next(tcfg, device="cpu", params=tparams)
                      .next_token(toks), int)
    assert len(list(GPT2Stream(tcfg, device="cpu", params=tparams)
                    .generate(toks[:60], 5))) == 5


def test_replica_builds_its_own_weights_from_a_seed(setup):
    _, tcfg, _, _ = setup
    a = GPT2Next(tcfg, seed=3, device="cpu")
    b = GPT2Next(tcfg, seed=3, device="cpu")
    assert a.next_token([1, 2, 3]) == b.next_token([1, 2, 3])


@pytest.mark.parametrize("cls", [GPT2Next, GPT2Stream])
def test_default_model_is_gpt2_124m_on_the_kernel(monkeypatch, cls):
    """Without a config the replica serves GPTConfig(): GPT-2 124M, bf16,
    attention on the splash kernel (init stubbed: no full-size model here)."""
    seen = {}

    def fake_init(config, seed, device):
        seen.update(config=config, device=device)
        raise RuntimeError("stop")

    monkeypatch.setattr(tgpt2, "init_params", fake_init)
    with pytest.raises(RuntimeError, match="stop"):
        cls(device="cpu")
    assert seen["config"] == tgpt2.GPTConfig()
    assert seen["config"].attn_impl == "auto"
    assert seen["config"].dtype == torch.bfloat16
    assert tgpt2.num_params(seen["config"]) == 124_475_904


# ------------------------------------------------- over HTTP, through serve.run
class _RefNextDeployment:
    """examples/serve_gpt2.py:GPT2Next at this file's config and weights."""

    def __init__(self, config, params):
        self.params = params
        self._fwd = jax.jit(lambda p, t: jgpt2.forward(p, t, config))

    async def __call__(self, request):
        body = await request.json()
        tokens = np.asarray(body["tokens"], np.int32)[None, :]
        logits = self._fwd(self.params, jnp.asarray(tokens))
        return {"next_token": int(jnp.argmax(logits[0, -1]))}


class _RefStreamDeployment:
    """examples/serve_gpt2.py:GPT2Stream at this file's config and weights."""

    def __init__(self, config, params):
        self.config, self.params = config, params
        self._fwd = jax.jit(lambda p, t: jgpt2.forward(p, t, config))

    def __call__(self, request):
        tokens = [int(t) for t in
                  request.query_params.get("tokens", "1,2,3").split(",")]
        n = int(request.query_params.get("max_new", "8"))
        S = self.config.seq_len
        for _ in range(n):
            arr = np.zeros((1, S), np.int32)
            arr[0, :len(tokens)] = tokens
            logits = self._fwd(self.params, jnp.asarray(arr))
            nxt = int(jnp.argmax(logits[0, len(tokens) - 1]))
            tokens.append(nxt)
            yield json.dumps({"token": nxt})


_UNARY = [1, 2, 3, 4]
_PROMPT, _MAX_NEW = [1, 2, 3], 5


def _example_requests(pkg, next_cls, stream_cls, *args, **kwargs):
    """Serve the example's two apps on ``pkg`` and send its two requests:
    the unary POST's JSON, and the SSE stream's Content-Type and events."""
    import importlib
    import urllib.request

    from _torch_runtimes import fresh_init

    serve = importlib.import_module(pkg.__name__ + ".serve")
    api = importlib.import_module(pkg.__name__ + ".serve.api")
    fresh_init(pkg, num_cpus=4)
    try:
        serve.start(http_options={"port": 0})
        serve.run(serve.deployment(num_replicas=1)(next_cls).bind(
            *args, **kwargs), name="gpt2", route_prefix="/gpt2")
        serve.run(serve.deployment(num_replicas=1)(stream_cls).bind(
            *args, **kwargs), name="gpt2stream", route_prefix="/gpt2stream")
        addr = api._state["proxy"].address
        req = urllib.request.Request(
            f"{addr}/gpt2", data=json.dumps({"tokens": _UNARY}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            unary = json.load(resp)
        stream_req = urllib.request.Request(
            f"{addr}/gpt2stream?tokens={','.join(map(str, _PROMPT))}"
            f"&max_new={_MAX_NEW}", headers={"Accept": "text/event-stream"})
        with urllib.request.urlopen(stream_req, timeout=60) as resp:
            ctype = resp.headers["Content-Type"]
            events = [json.loads(line[len(b"data: "):])
                      for line in resp.read().split(b"\n\n") if line]
        return unary, ctype, events
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


@pytest.fixture(scope="module")
def over_http(setup):
    """Both example apps over HTTP: the reference's (ray_tpu.serve, JAX
    forward) and the port's (ray_tpu_torch.serve, on the CPU), one after
    the other."""
    import ray_tpu
    import ray_tpu_torch
    from _torch_runtimes import gc_paused

    jcfg, tcfg, jparams, tparams = setup
    with gc_paused():
        ref = _example_requests(ray_tpu, _RefNextDeployment,
                                _RefStreamDeployment, jcfg, jparams)
        port = _example_requests(ray_tpu_torch, GPT2Next, GPT2Stream, tcfg,
                                 device="cpu", params=tparams)
    return ref, port


def test_http_answers_match_the_reference_example(setup, over_http):
    jcfg, _, jparams, _ = setup
    (ref_unary, ref_ctype, ref_events), (unary, ctype, events) = over_http
    assert set(unary) == set(ref_unary) == {"next_token"}
    assert ctype.startswith("text/event-stream")
    assert ctype == ref_ctype
    assert len(events) == len(ref_events) == _MAX_NEW
    _, ref_logits = _RefNext(jcfg, jparams)(_UNARY)
    assert _near_tie(unary["next_token"], ref_logits)
    ref = _RefStream(jcfg, jparams)
    seq = list(_PROMPT)
    for event in events:  # the reference along the port's own trajectory
        assert _near_tie(event["token"], ref.step_logits(seq))
        seq.append(event["token"])


def test_http_answers_equal_the_in_process_answers(setup, over_http):
    """The same weights on the same path: serving over HTTP changes no
    token."""
    _, tcfg, _, tparams = setup
    _, (unary, _, events) = over_http
    assert unary == {"next_token": GPT2Next(tcfg, device="cpu",
                                            params=tparams).next_token(_UNARY)}
    assert [e["token"] for e in events] == list(
        GPT2Stream(tcfg, device="cpu", params=tparams).generate(
            _PROMPT, _MAX_NEW))


def test_example_runs_on_the_cpu(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.examples.serve_gpt2",
         "--device", "cpu", "--tiny"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "serve_gpt2 OK"
