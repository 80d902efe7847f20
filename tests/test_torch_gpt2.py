"""The port's GPT-2 (ray_tpu_torch.models.gpt2) against the JAX package's.

Both sides get the same parameters (JAX's init, as numpy, through the
converter) and the same tokens (numpy, from a seed), at a small width:
2 layers, D=128, 2 heads of 64, S=128, splash tiles of 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2

_SMALL = dict(vocab_size=256, n_layer=2, n_head=2, d_model=128, seq_len=128,
              attn_block_q=128, attn_block_kv=128, remat=False)
_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(attn_impl="xla", dtype="fp32", **kw):
    jdt, tdt = _DTYPES[dtype]
    fields = dict(_SMALL, attn_impl=attn_impl, **kw)
    return (jgpt2.GPTConfig(dtype=jdt, logits_dtype=jdt, **fields),
            tgpt2.GPTConfig(dtype=tdt, logits_dtype=tdt, **fields))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (2, 128)).astype(np.int32),
            rng.integers(0, 256, (2, 128)).astype(np.int32))


def _jax_forward(params, toks, jcfg):
    return np.asarray(jax.jit(lambda p, t: jgpt2.forward(p, t, jcfg))(
        params, jnp.asarray(toks)), np.float32)


def _jax_loss(params, toks, tgts, jcfg):
    return float(jax.jit(lambda p, t, y: jgpt2.loss_fn(p, t, y, jcfg))(
        params, jnp.asarray(toks), jnp.asarray(tgts)))


def test_converter_round_trip(jax_params):
    params = convert.params_from_numpy(jax_params, device="cpu")
    assert params["blocks"]["qkv_w"].shape == (2, 128, 384)
    back = convert.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize("attn_impl", ["xla", "splash", "auto"])
def test_forward_matches_jax_fp32(jax_params, tokens, attn_impl):
    jcfg, tcfg = _configs(attn_impl)
    params = convert.params_from_numpy(jax_params, device="cpu")
    expected = _jax_forward(jax_params, tokens[0], jcfg)
    out = tgpt2.forward(params, torch.as_tensor(tokens[0], dtype=torch.long),
                        tcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 128, 256)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-4, atol=1e-4)


def test_pallas_impl_is_the_splash_path(jax_params, tokens):
    """attn_impl="pallas" reaches the same kernel through flash_attention."""
    params = convert.params_from_numpy(jax_params, device="cpu")
    toks = torch.as_tensor(tokens[0], dtype=torch.long)
    assert torch.equal(tgpt2.forward(params, toks, _configs("pallas")[1]),
                       tgpt2.forward(params, toks, _configs("splash")[1]))


@pytest.mark.parametrize("attn_impl", ["xla", "splash"])
@pytest.mark.parametrize("loss_chunk", [0, 32])
def test_loss_matches_jax_fp32(jax_params, tokens, attn_impl, loss_chunk):
    jcfg, tcfg = _configs(attn_impl, loss_chunk=loss_chunk)
    params = convert.params_from_numpy(jax_params, device="cpu")
    expected = _jax_loss(jax_params, *tokens, jcfg)
    loss = tgpt2.loss_fn(params, *(torch.as_tensor(t, dtype=torch.long)
                                   for t in tokens), tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), expected, rtol=1e-5, atol=1e-4)


def test_forward_and_loss_match_jax_bf16(jax_params, tokens):
    """bf16 matmuls on both sides. Tolerance 2e-2 on logits of magnitude
    up to ~2 (about 3x the 6.6e-3 measured) and 1e-3 on the loss: the two
    frameworks round to bf16 at different points (XLA's attention einsum
    rounds the scores to bf16 before the fp32 softmax, the port keeps them
    fp32; matmul accumulation orders differ), and each rounding is 2**-8
    relative."""
    jcfg, tcfg = _configs("xla", "bf16")
    params = convert.params_from_numpy(jax_params, device="cpu")
    toks = torch.as_tensor(tokens[0], dtype=torch.long)
    out = tgpt2.forward(params, toks, tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               _jax_forward(jax_params, tokens[0], jcfg),
                               atol=2e-2)
    loss = tgpt2.loss_fn(params, toks,
                         torch.as_tensor(tokens[1], dtype=torch.long), tcfg)
    np.testing.assert_allclose(float(loss),
                               _jax_loss(jax_params, *tokens, jcfg), atol=1e-3)


def test_inference_params_give_the_same_logits(jax_params, tokens):
    _, tcfg = _configs("xla", "bf16")
    params = convert.params_from_numpy(jax_params, device="cpu")
    toks = torch.as_tensor(tokens[0], dtype=torch.long)
    cast = tgpt2.inference_params(params, tcfg)
    assert cast["wte"].dtype == torch.bfloat16
    assert cast["blocks"]["ln1_scale"].dtype == torch.float32
    assert torch.equal(tgpt2.forward(params, toks, tcfg),
                       tgpt2.forward(cast, toks, tcfg))


@pytest.mark.parametrize("config", [
    dict(), dict(vocab_size=1024, n_layer=2, n_head=4, d_model=128,
                 seq_len=128), dict(n_layer=24, d_model=1024, n_head=16)])
def test_num_params_and_flops_match_jax(config):
    jcfg, tcfg = jgpt2.GPTConfig(**config), tgpt2.GPTConfig(**config)
    assert tgpt2.num_params(tcfg) == jgpt2.num_params(jcfg)
    assert tgpt2.flops_per_token(tcfg) == jgpt2.flops_per_token(jcfg)


def test_init_params_layout_and_scheme():
    _, tcfg = _configs()
    jcfg, _ = _configs()
    params = tgpt2.init_params(tcfg, seed=0, device="cpu")
    jshapes = jax.eval_shape(
        lambda: jgpt2.init_params(jcfg, jax.random.key(0)))
    assert ({str(p): tuple(x.shape)
             for p, x in jax.tree_util.tree_leaves_with_path(params)}
            == {str(p): tuple(x.shape)
                for p, x in jax.tree_util.tree_leaves_with_path(jshapes)})
    assert sum(x.numel() for x in jax.tree.leaves(params)) == \
        tgpt2.num_params(tcfg)
    blk = params["blocks"]
    assert torch.all(blk["ln1_scale"] == 1) and torch.all(blk["qkv_b"] == 0)
    assert abs(params["wte"].std().item() - 0.02) < 2e-3
    assert abs(params["wpe"].std().item() - 0.01) < 1e-3
    resid = 0.02 / np.sqrt(2 * tcfg.n_layer)
    assert abs(blk["out_w"].std().item() - resid) < 1e-3
    again = tgpt2.init_params(tcfg, seed=0, device="cpu")
    other = tgpt2.init_params(tcfg, seed=1, device="cpu")
    assert torch.equal(params["wte"], again["wte"])
    assert not torch.equal(params["wte"], other["wte"])


@pytest.mark.parametrize("attn_impl", ["xla", "splash"])
def test_causality(attn_impl):
    """Changing a future token must not affect earlier logits."""
    config = tgpt2.GPTConfig(vocab_size=256, n_layer=1, n_head=2, d_model=128,
                             seq_len=32, remat=False, attn_impl=attn_impl,
                             dtype=torch.float32)
    params = tgpt2.init_params(config, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    t1 = rng.integers(0, 256, (1, 32))
    t2 = t1.copy()
    t2[0, -1] = (t2[0, -1] + 1) % 256
    l1 = tgpt2.forward(params, torch.as_tensor(t1), config)
    l2 = tgpt2.forward(params, torch.as_tensor(t2), config)
    np.testing.assert_allclose(l1[0, :-1], l2[0, :-1], atol=1e-4)
    assert not np.allclose(l1[0, -1], l2[0, -1], atol=1e-4)


def test_fused_loss_is_not_ported_yet(tokens):
    """The fused loss is ported now (tests/test_torch_fused_ce.py): it runs
    and equals the dense loss with fp32 logits; an unknown loss_impl still
    raises."""
    _, tcfg = _configs(loss_impl="fused")
    params = tgpt2.init_params(tcfg, seed=0, device="cpu")
    toks = torch.as_tensor(tokens[0], dtype=torch.long)
    np.testing.assert_allclose(
        float(tgpt2.loss_fn(params, toks, toks, tcfg)),
        float(tgpt2.loss_fn(params, toks, toks,
                            dataclasses.replace(tcfg, loss_impl="dense"))),
        rtol=1e-5)
    with pytest.raises(ValueError, match="loss_impl"):
        tgpt2.loss_fn(params, toks, toks,
                      dataclasses.replace(tcfg, loss_impl="sparse"))


@pytest.mark.parametrize("kw,err", [
    # Context parallelism needs a mesh: none is installed here.
    (dict(attn_impl="ring"), ValueError),
    (dict(attn_impl="ulysses"), ValueError),
    # Pipelined without a pipe mesh: the reference's ValueError (its batch
    # of 1 does not divide into 2 microbatches; with one that does, no
    # mesh).
    (dict(pp_stages=2), ValueError),
    (dict(attn_impl="bogus"), ValueError)])
def test_unported_or_unknown_paths_raise(kw, err):
    _, tcfg = _configs(**kw)
    params = tgpt2.init_params(tgpt2.GPTConfig(**_SMALL), seed=0, device="cpu")
    with pytest.raises(err):
        tgpt2.forward(params, torch.zeros((1, 8), dtype=torch.long), tcfg)


@pytest.mark.parametrize("kw", [
    dict(save_mlp_act=True),
    dict(remat=True, remat_policy="attn_outside", attn_impl="xla"),
    dict(remat=True, remat_policy="nope")])
def test_config_errors_mirror_jax(jax_params, kw):
    jcfg, tcfg = _configs(**kw)
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError):
        jgpt2.forward(jax_params, jnp.asarray(toks), jcfg)
    params = convert.params_from_numpy(jax_params, device="cpu")
    with pytest.raises(ValueError):
        tgpt2.forward(params, torch.as_tensor(toks, dtype=torch.long), tcfg)


def test_remat_and_scan_fields_do_not_change_the_forward(jax_params, tokens):
    _, base = _configs()
    params = convert.params_from_numpy(jax_params, device="cpu")
    toks = torch.as_tensor(tokens[0], dtype=torch.long)
    expected = tgpt2.forward(params, toks, base)
    for kw in (dict(remat=True, remat_policy="full"),
               dict(remat=True, remat_policy="attn_outside", attn_impl="auto",
                    save_mlp_act=True),
               dict(scan_layers=False, scan_unroll=4)):
        cfg = dataclasses.replace(base, **kw)
        assert torch.equal(tgpt2.forward(params, toks, cfg), expected), kw
