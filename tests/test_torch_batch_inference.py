"""Batch inference through the port's Data (ray_tpu_torch.examples.
batch_inference: ``GPT2Scorer`` on an actor pool of ``map_batches``)
against the JAX package's GPT-2 forward on the same weights, and the GPU
leases of the pool's actors.

At a tiny GPT-2 in float32 on the CPU, each row's next token must equal the
argmax of the JAX logits at the last position, and its mean next-token loss
the numpy logsumexp of the JAX logits less the target's, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_runtimes import fresh_init
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import data
from ray_tpu_torch.examples import batch_inference
from ray_tpu_torch.models import gpt2 as tgpt2

_FIELDS = dict(vocab_size=256, n_layer=2, n_head=2, d_model=64, seq_len=32)
ROWS = 64
NLL_ATOL = 1e-4  # fp32 on both sides


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt2.GPTConfig(dtype=jnp.float32, logits_dtype=jnp.float32,
                           attn_impl="xla", attn_block_q=32, attn_block_kv=32,
                           **_FIELDS)
    tcfg = tgpt2.GPTConfig(dtype=torch.float32, logits_dtype=torch.float32,
                           **_FIELDS)
    params = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.key(0)))
    tokens = batch_inference.token_windows(ROWS, tcfg.seq_len, tcfg.vocab_size)
    logits = np.asarray(jax.jit(lambda p, t: jgpt2.forward(p, t, jcfg))(
        params, jnp.asarray(tokens[:, :-1], jnp.int32)), np.float64)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    tgt = np.take_along_axis(logits, tokens[:, 1:, None], -1)[..., 0]
    ref = {"next_token": logits[:, -1].argmax(-1),
           "nll": (lse - tgt).mean(-1)}
    return tcfg, params, tokens, ref


@pytest.fixture
def runtime():
    yield lambda **kw: fresh_init(ray_tpu_torch, **kw)
    ray_tpu_torch.shutdown()


def _check(out, ref):
    np.testing.assert_array_equal(out["next_token"], ref["next_token"])
    np.testing.assert_allclose(out["nll"], ref["nll"], rtol=0, atol=NLL_ATOL)


def test_scorer_matches_jax_forward(model):
    cfg, params, tokens, ref = model
    scorer = batch_inference.GPT2Scorer(cfg, device="cpu", params=params)
    out = scorer({"row": np.arange(ROWS), "tokens": tokens})
    assert out["next_token"].dtype == np.int64
    assert out["nll"].dtype == np.float32
    np.testing.assert_array_equal(out["row"], np.arange(ROWS))
    _check(out, ref)


def test_map_batches_actor_pool_matches_jax_forward(model, runtime):
    cfg, params, tokens, ref = model
    runtime(num_cpus=4, num_gpus=0)
    ds = batch_inference.token_dataset(tokens, blocks=4).map_batches(
        batch_inference.GPT2Scorer, batch_size=16, concurrency=1,
        fn_constructor_args=(cfg, 0, "cpu", params))
    out = {}
    for b in ds.iter_batches(batch_size=16):
        for k, v in b.items():
            out.setdefault(k, []).append(v)
    out = {k: np.concatenate(v) for k, v in out.items()}
    np.testing.assert_array_equal(np.sort(out["row"]), np.arange(ROWS))
    order = np.argsort(out["row"])
    _check({k: v[order] for k, v in out.items()}, ref)


def test_two_pool_actors_lease_one_card_each(model, runtime):
    """Two faked cards: ``concurrency=2, num_gpus=1`` gives each pool actor
    its own card index, and both cards come back once the pass ends."""
    cfg, params, tokens, _ = model
    runtime(num_cpus=4, num_gpus=2)
    before = len(batch_inference.CONSTRUCTED)
    ds = batch_inference.token_dataset(tokens, blocks=8).map_batches(
        batch_inference.GPT2Scorer, batch_size=8, num_gpus=1, concurrency=2,
        fn_constructor_args=(cfg, 0, "cpu", params))
    assert ds._op.compute.resources == {"GPU": 1}
    rows = sorted(r for b in ds.iter_batches(batch_size=8)
                  for r in b["row"].tolist())
    assert rows == list(range(ROWS))
    built = batch_inference.CONSTRUCTED[before:]
    assert sorted(tuple(c["gpu_ids"]) for c in built) == [(0,), (1,)]
    assert ray_tpu_torch.available_resources()["GPU"] == 2.0


def test_num_gpus_is_a_lease_not_a_compat_keyword():
    def ident(b):
        return b

    ds = data.range(4).map_batches(ident, num_gpus=0.5)
    assert ds._op.compute.resources == {"GPU": 0.5}
    assert ds._op.compute.kind == "actors"
    # The reference's accelerator keyword is no lease here.
    assert data.range(4).map_batches(ident, num_tpus=1)._op.compute.kind \
        == "tasks"


def test_iter_torch_batches_defaults_to_the_card(monkeypatch, runtime):
    runtime(num_cpus=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(data.range(4).iter_torch_batches(batch_size=2)))
    batch = next(iter(data.range(4).iter_torch_batches(batch_size=2,
                                                       device="cpu")))
    assert batch["id"].device.type == "cpu"
    assert batch["id"].tolist() == [0, 1]


def test_device_batch_iterator_needs_a_card_by_default(monkeypatch):
    from ray_tpu_torch.data.ingest import DeviceBatchIterator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBatchIterator([])


def test_example_main_on_the_cpu(capsys):
    assert batch_inference.main(["--device", "cpu", "--tiny", "--rows", "96",
                                 "--blocks", "3", "--batch", "16"]) == 0
    assert "batch_inference rows=96" in capsys.readouterr().out
