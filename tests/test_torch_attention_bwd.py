"""The port's attention gradient (``SplashAttention``, ``splash_attention_bwd``,
``attention_bwd_reference``) against the JAX package.

On the CPU the Function runs the plain versions, so these tests hold the
backward formula the Hopper kernel computes to ``jax.grad`` of the JAX
splash kernel (interpret mode, blocks of 128) and of the JAX einsum
attention, in fp32 (atol 1e-4). The kernel itself is held to the plain
version on the GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import splash_attention as jax_splash
from ray_tpu.ops.ring_attention import _xla_attention
from ray_tpu_torch.ops import attention

ATOL = 1e-4


def _inputs(seed, B=1, S=256, H=2, D=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _port_grads(q, k, v, do, fn=attention.splash_attention, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(do))
    return out, [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, do):
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                            argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
def test_gradient_matches_jax_splash(causal):
    q, k, v, do = _inputs(0)
    expected = _jax_grads(lambda q, k, v: jax_splash(
        q, k, v, causal=causal, block_q=128, block_kv=128), q, k, v, do)
    out, grads = _port_grads(q, k, v, do, causal=causal, block_q=128,
                             block_kv=128)
    assert type(out.grad_fn).__name__ == "SplashAttentionBackward"
    for got, want in zip(grads, expected):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [7, 100])
def test_ragged_gradient_matches_jax_einsum(causal, S):
    """S a multiple of no tile: against jax.grad of the JAX einsum path."""
    q, k, v, do = _inputs(1, B=2, S=S, H=3)
    expected = _jax_grads(lambda q, k, v: _xla_attention(
        q, k, v, causal=causal), q, k, v, do)
    _, grads = _port_grads(q, k, v, do, causal=causal)
    for got, want in zip(grads, expected):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_sm_scale_reaches_the_gradient():
    q, k, v, do = _inputs(2, S=48, D=128)
    expected = _jax_grads(lambda q, k, v: _xla_attention(
        q, k, v, causal=True, sm_scale=0.3), q, k, v, do)
    _, grads = _port_grads(q, k, v, do, sm_scale=0.3)
    for got, want in zip(grads, expected):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_backward_matches_autograd_of_the_forward(causal):
    """attention_bwd_reference's explicit formula equals autograd through
    attention_reference, the plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, B=2, S=40, H=2))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    o, _ = attention.attention_reference(qt, kt, vt, causal=causal)
    o.backward(do)
    o, lse = attention.attention_reference(q, k, v, causal=causal)
    got = attention.attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal)
    for g, t in zip(got, (qt, kt, vt)):
        torch.testing.assert_close(g, t.grad, atol=1e-5, rtol=1e-5)


def test_external_lse_and_delta_give_the_functions_backward():
    """splash_attention_bwd with the caller's lse and delta (the ring
    backward's entry) equals the gradient SplashAttention computes."""
    q, k, v, do = _inputs(4, B=2, S=64, H=2)
    _, grads = _port_grads(q, k, v, do)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = attention.splash_attention(qt, kt, vt, return_lse=True)
    delta = (o * dot).sum(-1).transpose(1, 2)
    ext = attention.splash_attention_bwd(qt, kt, vt, o, lse, dot,
                                         causal=True, delta=delta)
    for got, want in zip(ext, grads):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_flash_gradient_is_splash_gradient():
    """attn_impl="pallas" (row 4) differentiates through the same Function."""
    q, k, v, do = _inputs(5, S=32)
    _, a = _port_grads(q, k, v, do, fn=attention.flash_attention, block=16)
    _, b = _port_grads(q, k, v, do)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_lse_is_not_differentiable():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(6, S=16)[:3])
    o, lse = attention.splash_attention(q, k, v, return_lse=True)
    assert o.requires_grad and not lse.requires_grad


def test_cpu_forward_and_backward_launch_no_kernel():
    attention.reset_launches()
    q, k, v, do = _inputs(7, S=32)
    _port_grads(q, k, v, do)
    _port_grads(q, k, v, do, fn=attention.flash_attention)
    assert attention.LAUNCHES == {"splash_attention_fwd": 0,
                                  "splash_attention_bwd": 0}


@pytest.mark.parametrize("kw,err", [
    (dict(dtype=torch.float32), TypeError),
    (dict(hd=32), ValueError),
    (dict(lse_shape=(1, 8, 2)), ValueError),
    (dict(delta_shape=(1, 2, 4)), ValueError)])
def test_backward_kernel_wrapper_refuses_before_launch(kw, err):
    """What the backward kernel does not take raises in the wrapper, before
    any build or launch."""
    hd, dt = kw.get("hd", 64), kw.get("dtype", torch.bfloat16)
    x = torch.zeros((1, 8, 2, hd), dtype=dt)
    lse = torch.zeros(kw.get("lse_shape", (1, 2, 8)))
    delta = torch.zeros(kw["delta_shape"]) if "delta_shape" in kw else None
    with pytest.raises(err):
        attention._splash_bwd_cuda(x, x, x, x, lse, x, delta, True, 0.125)


def test_kernel_inputs_copy_a_misaligned_do():
    """The backward kernel's tensor maps read q, k, v and do: the qkv-split
    views and a contiguous do pass as they are; a do whose base is not
    16-byte aligned (as autograd may hand it over) is copied into aligned
    storage before a map is made from it."""
    B, S, H, hd = 2, 16, 3, 64
    qkv = torch.randn((B, S, 3 * H * hd)).to(torch.bfloat16)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn((B, S, H, hd)).to(torch.bfloat16)
    named = {"q": q, "k": k, "v": v, "do": do}
    assert all(y is x for x, y in zip(named.values(),
                                      attention._kernel_inputs(named)))
    n = B * S * H * hd
    flat = torch.randn(n + 8).to(torch.bfloat16)
    shifted = flat[1:1 + n].view(B, S, H, hd)  # base 2 bytes past 16
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    out = attention._kernel_inputs({**named, "do": shifted})
    assert all(y is x for x, y in zip((q, k, v), out[:3]))
    assert out[3].data_ptr() % 16 == 0 and attention._row_aligned(out[3])
    assert torch.equal(out[3], shifted)
