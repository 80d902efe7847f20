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
from ray_tpu_torch.ops import ring_attention as ra
from ray_tpu_torch.parallel import MeshSpec, use_mesh


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _rel(x, ref):
    return ((x.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 517, 12, 64), (32, 1024, 12, 64)])
def test_kernel_matches_plain_at_batched_serving_shapes_on_gpu(shape):
    """The batches ``serve.batch`` forms for GPT-2 124M: up to 32 requests
    right-padded to the longest, which is mostly not a multiple of the
    kernel's tile."""
    _need_gpu()
    B, S, H, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    o, lse = attention.splash_attention(q, k, v, causal=True,
                                        return_lse=True)
    o_ref, lse_ref = attention.attention_reference(q, k, v, causal=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((8, 1024, 12, 64), True), ((1, 1000, 12, 64), False),
    ((1, 1000, 12, 64), True), ((1, 7, 12, 64), True),
    ((3, 7, 12, 64), False), ((2, 512, 8, 128), True),
    ((2, 512, 8, 128), False)])
def test_kernel_matches_plain_on_gpu(shape, causal):
    """q, k, v split from a fused qkv, as the model makes them: the tensor
    maps read the strided views; rows past a ragged S, and the whole box
    past S=7, arrive as zeros."""
    _need_gpu()
    B, S, H, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
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
    ((1, 1000, 12, 64), True), ((1, 7, 12, 64), True),
    ((3, 7, 12, 64), False), ((2, 512, 8, 128), True),
    ((2, 512, 8, 128), False)])
def test_backward_kernel_matches_plain_on_gpu(shape, causal):
    """q, k, v split from a fused qkv, as the model makes them; the gradient
    through SplashAttention launches the backward kernel once. Rows past a
    ragged S, and the whole tile past S=7, arrive from the tensor maps as
    zeros and must be masked."""
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
def test_backward_kernel_is_deterministic_on_gpu():
    """No atomics: two backward calls on the same inputs at the training
    shape give dq, dk and dv equal bit for bit."""
    _need_gpu()
    B, S, H, hd = 16, 1024, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    o, lse = attention.splash_attention(q, k, v, return_lse=True)
    first = attention.splash_attention_bwd(q, k, v, o, lse, do)
    second = attention.splash_attention_bwd(q, k, v, o, lse, do)
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(4096, 768, 50304), (24, 64, 96),
                                   (1000, 768, 50257), (300, 128, 1000),
                                   (7, 768, 50), (65, 768, 97),
                                   (65, 128, 97), (7, 64, 50),
                                   (130, 768, 50257)])
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


@pytest.mark.cuda
def test_fused_ce_forward_is_deterministic_on_gpu():
    """Each block sums its vocab tiles in one order and the two consumer
    warpgroups' halves merge in one order: two runs at GPT-2 124M's
    training shape give the same bits."""
    _need_gpu()
    N, D, V = 16384, 768, 50304
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((N, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    first = fused_ce.ce_fwd(x, w, t)
    second = fused_ce.ce_fwd(x, w, t)
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
def test_fused_ce_forward_takes_a_view_off_16_bytes_on_gpu():
    """x starting 2 bytes into its storage is copied for the forward's
    tensor maps and gives the plain version's lse and tgt."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(10)
    N, D, V = 65, 768, 97
    buf = torch.randn(N * D + 1, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[1:].view(N, D)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    lse, tgt = fused_ce.ce_fwd(x, w, t)
    lse_r, tgt_r = fused_ce.ce_fwd_reference(x, w, t)
    assert (lse - lse_r).abs().max().item() <= 2e-3
    assert (tgt - tgt_r).abs().max().item() <= 2e-3


@pytest.mark.cuda
def test_fused_ce_backward_is_deterministic_on_gpu():
    """dx sums over V and dW over N inside one block, in one order: two runs
    at GPT-2 124M's training shape give the same bits."""
    _need_gpu()
    N, D, V = 16384, 768, 50304
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((N, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    lse, _ = fused_ce.ce_fwd(x, w, t)
    for grad in (fused_ce.ce_dx, fused_ce.ce_dw):
        first = grad(x, w, t, lse)
        second = grad(x, w, t, lse)
        assert torch.isfinite(first).all() and torch.equal(first, second)


@pytest.mark.cuda
def test_fused_ce_backward_takes_a_view_off_16_bytes_on_gpu():
    """x starting 2 bytes into its storage is copied for the tensor maps and
    gives the plain versions' dx and dW."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(8)
    N, D, V = 65, 768, 97
    buf = torch.randn(N * D + 1, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[1:].view(N, D)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    lse, _ = fused_ce.ce_fwd(x, w, t)
    assert _rel(fused_ce.ce_dx(x, w, t, lse),
                fused_ce.ce_dx_reference(x, w, t, lse)) <= 2e-2
    assert _rel(fused_ce.ce_dw(x, w, t, lse),
                fused_ce.ce_dw_reference(x, w, t, lse)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,shard,H,hd,causal", [
    (4, 256, 12, 64, True), (2, 250, 12, 64, True), (2, 256, 8, 128, True),
    (2, 256, 12, 64, False)])
def test_ring_kernels_match_plain_on_gpu(B, shard, H, hd, causal):
    """A W=4 ring forward and backward through the kernels (one launch per
    step each) against the same steps through the plain versions, q, k, v
    split from a fused qkv."""
    _need_gpu()
    W = 4
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((B, W * shard, 3 * H * hd), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.view(B, W * shard, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    before = dict(ra.LAUNCHES)
    o, lse = ra.ring_forward(q, k, v, world=W, causal=causal)
    grads = ra.ring_backward(q, k, v, o, lse, do, world=W, causal=causal)
    assert {n: ra.LAUNCHES[n] - before[n] for n in before} == {
        "ring_attention_fwd": W, "ring_attention_bwd": W}
    o_ref, lse_ref = ra.ring_forward(q, k, v, world=W, causal=causal,
                                     plain=True)
    assert (o - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    refs = ra.ring_backward(q, k, v, o, lse, do, world=W, causal=causal,
                            plain=True)
    for g, r in zip(grads, refs):
        assert torch.isfinite(g).all() and _rel(g, r) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,shard,H,hd,causal", [
    (4, 256, 12, 64, True), (2, 250, 12, 64, True), (2, 256, 8, 128, True),
    (2, 256, 12, 64, False)])
def test_ring_first_step_reads_no_accumulator_on_gpu(B, shard, H, hd, causal):
    """Step 0 through the kernels writes every row of o, lse, dq, dk, dv and
    reads none: from NaN-filled accumulators it gives exactly what it gives
    from o = 0, lse = -1e30 and zeros, within the plain step's tolerance."""
    _need_gpu()
    W = 4
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((B, W * shard, 3 * H * hd), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.view(B, W * shard, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    o_ref, lse_ref = ra.ring_forward(q, k, v, world=W, causal=causal)
    delta = ra.ring_delta(o_ref, do)
    runs = {}
    for fill in ("nan", "zero", "plain"):
        nan = fill == "nan"
        o = torch.full(q.shape, float("nan") if nan else 0.0, device="cuda")
        lse = torch.full((B, H, W * shard), float("nan") if nan else ra._NEG,
                         device="cuda")
        grads = [torch.full(q.shape, float("nan") if nan else 0.0,
                            device="cuda") for _ in range(3)]
        fwd = ra.ring_fwd_step_plain if fill == "plain" else ra.ring_fwd_step
        bwd = ra.ring_bwd_step_plain if fill == "plain" else ra.ring_bwd_step
        fwd(q, k, v, o, lse, step=0, world=W, causal=causal)
        bwd(q, k, v, do, lse_ref, delta, *grads, step=0, world=W,
            causal=causal)
        runs[fill] = (o, lse, *grads)
    for a, b in zip(runs["nan"], runs["zero"]):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    o, lse, *grads = runs["nan"]
    o_p, lse_p, *grads_p = runs["plain"]
    assert (o - o_p).abs().max().item() <= 2e-2
    assert (lse - lse_p).abs().max().item() <= 1e-3
    for g, r in zip(grads, grads_p):
        assert _rel(g, r) <= 2e-2


@pytest.mark.cuda
def test_ring_attention_gradient_is_its_own_on_gpu():
    """attn_impl="ring"'s attention on the card: FusedRing's backward (four
    launches at W=4), within the splash kernels' tolerance of splash
    attention on the same q, k, v."""
    _need_gpu()
    B, S, H, hd = 2, 1024, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    outs, grads = [], []
    for ring in (True, False):
        q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        with use_mesh(MeshSpec(seq=4)):
            out = (ra.ring_attention(q, k, v) if ring
                   else attention.splash_attention(q, k, v))
        if ring:
            assert type(out.grad_fn).__name__ == "FusedRingBackward"
            before = ra.LAUNCHES["ring_attention_bwd"]
        (g,) = torch.autograd.grad(out, qkv, do)
        if ring:
            assert ra.LAUNCHES["ring_attention_bwd"] == before + 4
        outs.append(out)
        grads.append(g)
    assert (outs[0].float() - outs[1].float()).abs().max().item() <= 2e-2
    for a, b in zip(grads[0].split(H * hd, -1), grads[1].split(H * hd, -1)):
        assert _rel(a, b) <= 2e-2


@pytest.mark.cuda
def test_gpu_replica_over_http_runs_the_kernel():
    """serve.run on the card: a GPT2Next replica holding the GPU
    (num_gpus=1) answers a JSON POST through the HTTP proxy with the same
    token as the same replica body in-process, and the forward behind it
    launches the splash kernel once per layer."""
    _need_gpu()
    import json
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2

    config = gpt2.GPTConfig(n_layer=2)
    params = gpt2.init_params(config, seed=0, device="cuda")
    tokens = list(range(1, 65))
    want = serve.GPT2Next(config, params=params).next_token(tokens)
    ray_tpu_torch.init(num_cpus=4)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == \
            torch.cuda.device_count()
        serve.start(http_options={"port": 0})
        serve.run(serve.deployment(ray_actor_options={"num_gpus": 1})(
            serve.GPT2Next).bind(config, params=params), name="gpt2",
            route_prefix="/gpt2")
        from ray_tpu_torch.serve.api import _state

        before = attention.LAUNCHES["splash_attention_fwd"]
        req = urllib.request.Request(
            f"{_state['proxy'].address}/gpt2",
            data=json.dumps({"tokens": tokens}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.load(resp)
        assert attention.LAUNCHES["splash_attention_fwd"] == \
            before + config.n_layer
        assert out == {"next_token": want}
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
