"""The port's fused LM-head cross-entropy (ray_tpu_torch.ops.fused_ce) against
the JAX package's (ray_tpu/ops/fused_ce.py, Pallas in interpret mode) and the
dense logsumexp path, forward and backward; mirrors tests/test_fused_ce.py.

On the CPU the Function runs the plain versions of the three kernels; the
kernels themselves are held to those on the GPU by tests/test_torch_cuda.py
and chip_smoke.py. fp32 tolerances are the reference test's (loss 1e-5,
dx/dW rtol 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops.fused_ce import fused_lm_head_ce as jax_fused_ce
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import fused_ce


def _data(seed, B, S, D, V, w_scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            (rng.standard_normal((V, D)) * w_scale).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32))


def _dense_ce(x, wte, targets):
    logits = jnp.einsum("bsd,vd->bsv", x, wte.astype(x.dtype),
                        preferred_element_type=jnp.float32)
    lse = jax.nn.logsumexp(logits, axis=-1)
    tgt = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(lse - tgt)


def _port(x, w, t, **kw):
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = fused_ce.fused_lm_head_ce(xt, wt, torch.from_numpy(t).long(), **kw)
    loss.backward()
    return loss.item(), xt.grad.numpy(), wt.grad.numpy()


def _jax(fn, x, w, t):
    loss, (dx, dw) = jax.jit(jax.value_and_grad(
        lambda a, b: fn(a, b, t), argnums=(0, 1)))(x, w)
    return float(loss), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("bwd_impl", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(2, 64, 32, 256), (1, 24, 16, 96)],
                         ids=["2x64x32x256", "24rows_V96"])
def test_fused_ce_matches_jax_fused_and_dense(bwd_impl, shape):
    x, w, t = _data(0, *shape)
    got = _port(x, w, t, bwd_impl=bwd_impl)
    for want in (_jax(lambda a, b, c: jax_fused_ce(a, b, c,
                                                   bwd_impl=bwd_impl), x, w, t),
                 _jax(_dense_ce, x, w, t)):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)


def test_fused_ce_bf16():
    """bf16 hidden states (the training type), fp32 wte cast to bf16 as the
    reference casts it. Against the fp32 dense loss the reference test's
    0.05; against the JAX fused kernel on the same bf16 inputs 1e-3 on the
    loss (both sum exact bf16 products in fp32, in other orders) and 2e-2
    of the largest entry on dx and dW (both round softmax - onehot to bf16,
    and a value on a rounding boundary may land one bf16 ulp apart)."""
    x, w, t = _data(1, 2, 32, 64, 512)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = fused_ce.fused_lm_head_ce(xb, wt, torch.from_numpy(t).long())
    loss.backward()
    assert xb.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    x16 = jnp.asarray(x, jnp.bfloat16)
    assert abs(loss.item() - float(_dense_ce(x16.astype(jnp.float32), w, t))) < 0.05
    want = _jax(jax_fused_ce, x16, w, t)
    assert abs(loss.item() - want[0]) < 1e-3
    for got, ref in ((xb.grad.float().numpy(), want[1].astype(np.float32)),
                     (wt.grad.numpy(), want[2])):
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_bad_bwd_impl_raises():
    x, w, t = (torch.from_numpy(a) for a in _data(2, 1, 8, 16, 32))
    with pytest.raises(ValueError, match="bwd_impl"):
        fused_ce.fused_lm_head_ce(x, w, t.long(), bwd_impl="triton")


def test_plain_versions_are_the_dense_gradient():
    """ce_dx_reference / ce_dw_reference are N times the dense loss's
    gradient (they are unscaled), and ce_fwd_reference its lse and target
    logit."""
    x, w, t = _data(3, 1, 40, 24, 72)
    x2, wt, tt = torch.from_numpy(x[0]), torch.from_numpy(w), torch.from_numpy(t[0])
    lse, tgt = fused_ce.ce_fwd_reference(x2, wt, tt)
    logits = x2 @ wt.t()
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(tgt, logits[torch.arange(40), tt.long()])
    _, dx, dw = _port(x, w, t)
    n = x2.shape[0]
    np.testing.assert_allclose(fused_ce.ce_dx_reference(x2, wt, tt, lse) / n,
                               dx[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fused_ce.ce_dw_reference(x2, wt, tt, lse) / n,
                               dw, rtol=1e-5, atol=1e-7)


def test_cpu_calls_launch_no_kernel():
    fused_ce.reset_launches()
    _port(*_data(4, 1, 16, 16, 48))
    _port(*_data(4, 1, 16, 16, 48), bwd_impl="xla")
    assert fused_ce.LAUNCHES == {"fused_ce_fwd": 0, "fused_ce_dx": 0,
                                 "fused_ce_dw": 0}


@pytest.mark.parametrize("dtype,D,err", [
    (torch.float32, 64, TypeError), (torch.bfloat16, 96, ValueError),
    (torch.bfloat16, 256, ValueError), (torch.bfloat16, 1024, ValueError)])
def test_kernel_wrapper_refuses_before_launch(dtype, D, err):
    """What the kernels do not take raises before any build or launch."""
    with pytest.raises(err):
        fused_ce._kernel_inputs(torch.zeros((8, D), dtype=dtype),
                                torch.zeros((16, D), dtype=dtype),
                                torch.zeros(8, dtype=torch.long))


def test_kernel_inputs_copy_a_view_off_16_bytes():
    """The backward kernels' TMA tensor maps take a base on 16 bytes: a view
    that starts elsewhere is copied before any launch; one that starts there
    is passed as it is."""
    buf = torch.arange(8 * 64 + 1, dtype=torch.float32).to(torch.bfloat16)
    x = buf[1:].view(8, 64)
    w = torch.ones((24, 64), dtype=torch.bfloat16)[8:]
    assert x.data_ptr() % 16 != 0 and w.data_ptr() % 16 == 0
    x2, w2, t2 = fused_ce._kernel_inputs(x, w, torch.zeros(8, dtype=torch.long))
    assert x2.data_ptr() % 16 == 0 and x2.is_contiguous()
    assert torch.equal(x2, x)
    assert w2.data_ptr() == w.data_ptr()
    assert t2.dtype == torch.int32


def test_gpt2_fused_loss_matches_jax_and_dense():
    """loss_impl="fused" in the port's GPT-2 equals the JAX fused loss and
    the port's dense loss with fp32 logits (mirrors
    tests/test_fused_ce.py::test_cost_model_and_gpt2_auto_dispatch)."""
    base = dict(vocab_size=128, n_layer=1, n_head=2, d_model=32, seq_len=32,
                remat=False, attn_impl="xla")
    jcfg = jgpt2.GPTConfig(**base, dtype=jnp.float32,
                           logits_dtype=jnp.float32, loss_impl="fused")
    tcfg = tgpt2.GPTConfig(**base, dtype=torch.float32,
                           logits_dtype=torch.float32, loss_impl="fused")
    jparams = jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.key(0)))
    params = convert.params_from_numpy(jparams, device="cpu")
    rng = np.random.default_rng(0)
    toks, tgts = (rng.integers(0, 128, (2, 32)).astype(np.int32)
                  for _ in range(2))
    want = float(jgpt2.loss_fn(jparams, jnp.asarray(toks), jnp.asarray(tgts),
                               jcfg))
    tt, ty = (torch.as_tensor(a, dtype=torch.long) for a in (toks, tgts))
    fused = tgpt2.loss_fn(params, tt, ty, tcfg)
    dense = tgpt2.loss_fn(params, tt, ty,
                          dataclasses.replace(tcfg, loss_impl="dense"))
    auto = tgpt2.loss_fn(params, tt, ty,
                         dataclasses.replace(tcfg, loss_impl="auto"))
    np.testing.assert_allclose(float(fused), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(fused), float(dense), rtol=1e-5, atol=1e-5)
    assert torch.equal(auto, dense)
