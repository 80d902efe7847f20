"""The port's attention (ray_tpu_torch.ops.attention) against the JAX package.

On the CPU the wrappers run the plain PyTorch version, so these tests hold
that version to the JAX splash kernel (interpret mode, as
tests/test_long_context.py runs it) and to the JAX einsum attention, in fp32.
The Hopper kernel itself is held to the plain version on the GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import splash_attention as jax_splash
from ray_tpu.ops.ring_attention import _xla_attention
from ray_tpu_torch.ops import attention


def _qkv(seed, B=1, S=256, H=2, D=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
def test_splash_matches_jax_splash(causal):
    q, k, v = _qkv(0)
    expected = jax.jit(lambda q, k, v: jax_splash(
        q, k, v, causal=causal, block_q=128, block_kv=128))(q, k, v)
    out = attention.splash_attention(*_torch(q, k, v), causal=causal,
                                     block_q=128, block_kv=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [7, 100])
def test_ragged_seq_matches_jax_einsum(causal, S):
    """S not a multiple of any tile: against the JAX einsum attention."""
    q, k, v = _qkv(1, B=2, S=S, H=3, D=64)
    expected = _xla_attention(q, k, v, causal=causal)
    out = attention.splash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_numpy_logsumexp(causal):
    q, k, v = _qkv(2, B=2, S=50, H=2, D=128)
    _, lse = attention.splash_attention(*_torch(q, k, v), causal=causal,
                                        return_lse=True)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(128)
    if causal:
        scores = np.where(np.tril(np.ones((50, 50), bool)), scores, -np.inf)
    m = scores.max(-1, keepdims=True)
    expected = (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (2, 2, 50) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), expected, rtol=1e-5, atol=1e-5)


def test_sm_scale_is_applied():
    q, k, v = _qkv(3, S=32)
    expected = _xla_attention(q, k, v, causal=True, sm_scale=0.3)
    out = attention.splash_attention(*_torch(q, k, v), sm_scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                               rtol=2e-5, atol=2e-5)


def test_flash_is_splash():
    q, k, v = _torch(*_qkv(4, S=64))
    for causal in (True, False):
        assert torch.equal(
            attention.flash_attention(q, k, v, causal=causal, block=32),
            attention.splash_attention(q, k, v, causal=causal))


def test_cpu_calls_launch_nothing():
    attention.reset_launches()
    q, k, v = (t.requires_grad_() for t in _torch(*_qkv(5, S=16)))
    attention.splash_attention(q, k, v).sum().backward()
    attention.flash_attention(q, k, v).sum().backward()
    assert attention.LAUNCHES == {"splash_attention_fwd": 0,
                                  "splash_attention_bwd": 0}


def test_shape_mismatch_raises():
    q, k, v = _torch(*_qkv(6, S=16))
    with pytest.raises(ValueError, match="share one"):
        attention.splash_attention(q, k[:, :8], v)


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.float32, 64, TypeError), (torch.bfloat16, 32, ValueError),
    (torch.bfloat16, 96, ValueError)])
def test_kernel_wrapper_refuses_before_launch(dtype, hd, err):
    """What the kernel does not take raises in the wrapper, before any
    build or launch."""
    x = torch.zeros((1, 8, 2, hd), dtype=dtype)
    with pytest.raises(err):
        attention._splash_fwd_cuda(x, x, x, True, 0.125)


def test_qkv_split_views_go_to_the_kernel_uncopied():
    """The model's q, k, v are views of the fused qkv with a row stride of
    3*D: the kernel takes them as they are; a transposed view is copied."""
    B, S, H, hd = 2, 16, 3, 64
    qkv = torch.zeros((B, S, 3 * H * hd), dtype=torch.bfloat16)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    assert all(attention._row_aligned(x) for x in (q, k, v))
    assert not attention._row_aligned(q.transpose(-1, -2))


def test_kernel_inputs_keep_what_the_tensor_maps_take():
    """The forward kernel's tensor maps need each row contiguous and the
    base and every stride a multiple of 16 bytes: the qkv-split views pass
    as they are; a view whose base or row stride is off is copied into new,
    aligned storage."""
    B, S, H, hd = 2, 16, 3, 64
    qkv = torch.randn((B, S, 3 * H * hd)).to(torch.bfloat16)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    assert all(y is x for x, y in zip(
        (q, k, v), attention._kernel_inputs({"q": q, "k": k, "v": v})))
    n = B * S * H * hd
    flat = torch.randn(n + 8).to(torch.bfloat16)
    shifted = flat[1:1 + n].view(B, S, H, hd)  # base 2 bytes past 16
    wide = torch.randn((B, S, H * hd + 4)).to(torch.bfloat16)
    padded = wide[..., :H * hd].view(B, S, H, hd)  # row stride 1544 bytes
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    out = attention._kernel_inputs({"q": shifted, "k": padded, "v": v})
    assert out[2] is v
    for x, y in zip((shifted, padded), out[:2]):
        assert y.data_ptr() != x.data_ptr() and attention._row_aligned(y)
        assert torch.equal(x, y)
