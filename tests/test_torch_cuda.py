"""The port's hand-written kernels against their plain versions, on the GPU.

Every test is marked ``cuda`` and skips without a CUDA device: a CUDA kernel
has no CPU mode. The file imports no JAX, so it runs on a machine without
it; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are chip_smoke.py's, with the reasons given there.
"""

import pytest
import torch

from ray_tpu_torch.ops import attention, fused_ce


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _rel(x, ref):
    return ((x.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((8, 1024, 12, 64), True), ((1, 1000, 12, 64), False),
    ((1, 7, 12, 64), True), ((2, 512, 8, 128), True)])
def test_kernel_matches_plain_on_gpu(shape, causal):
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = attention.LAUNCHES["splash_attention_fwd"]
    o, lse = attention.splash_attention(q, k, v, causal=causal,
                                        return_lse=True)
    assert attention.LAUNCHES["splash_attention_fwd"] == before + 1
    o_ref, lse_ref = attention.attention_reference(q, k, v, causal=causal)
    # bf16 output: the kernel and the plain version round the probabilities
    # at different points (see chip_smoke.py O_ATOL).
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((16, 1024, 12, 64), True), ((1, 1000, 12, 64), False),
    ((1, 7, 12, 64), True), ((2, 512, 8, 128), True)])
def test_backward_kernel_matches_plain_on_gpu(shape, causal):
    """q, k, v split from a fused qkv, as the model makes them; the gradient
    through SplashAttention launches the backward kernel once."""
    _need_gpu()
    B, S, H, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    o, lse = attention.splash_attention(q, k, v, causal=causal,
                                        return_lse=True)
    assert type(o.grad_fn).__name__ == "SplashAttentionBackward"
    before = attention.LAUNCHES["splash_attention_bwd"]
    o.backward(do)
    assert attention.LAUNCHES["splash_attention_bwd"] == before + 1
    refs = attention.attention_bwd_reference(q.detach(), k.detach(),
                                             v.detach(), o.detach(), lse, do,
                                             causal=causal)
    for g, r in zip(qkv.grad.split(H * hd, dim=-1), refs):
        assert _rel(g.reshape(shape), r) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(4096, 768, 50304), (24, 64, 96),
                                   (1000, 768, 50257), (300, 128, 1000)])
def test_fused_ce_kernels_match_plain_on_gpu(N, D, V):
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((N, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    before = dict(fused_ce.LAUNCHES)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = fused_ce.fused_lm_head_ce(xg[None], wg, t[None])
    loss.backward()
    assert {k: fused_ce.LAUNCHES[k] - before[k] for k in before} == {
        "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}
    lse, tgt = fused_ce.ce_fwd(x, w, t)
    lse_r, tgt_r = fused_ce.ce_fwd_reference(x, w, t)
    assert (lse - lse_r).abs().max().item() <= 2e-3
    assert (tgt - tgt_r).abs().max().item() <= 2e-3
    assert abs(loss.item() - (lse_r - tgt_r).mean().item()) <= 2e-3
    assert _rel(fused_ce.ce_dx(x, w, t, lse),
                fused_ce.ce_dx_reference(x, w, t, lse)) <= 2e-2
    assert _rel(fused_ce.ce_dw(x, w, t, lse),
                fused_ce.ce_dw_reference(x, w, t, lse)) <= 2e-2
