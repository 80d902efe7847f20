"""The port's hand-written kernels against their plain versions, on the GPU.

Every test is marked ``cuda`` and skips without a CUDA device: a CUDA kernel
has no CPU mode. The file imports no JAX, so it runs on a machine without
it; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are chip_smoke.py's, with the reasons given there.
"""

import dataclasses

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
@pytest.mark.parametrize("B,shard,H,hd,causal", [
    (4, 256, 12, 64, True), (2, 512, 12, 64, True), (2, 256, 8, 128, True),
    (2, 256, 12, 64, False)])
def test_per_rank_ring_steps_match_plain_and_folded_on_gpu(B, shard, H, hd,
                                                            causal):
    """The process ring's launch: one per rank per step on the rank's own
    shard (the diagonal and the full mask, the first step's write and the
    later steps' merge and add), each rank's o, lse, dq, dk, dv against the
    plain blocks within the ring's tolerance and against the folded
    launches over the same pairs bit for bit."""
    _need_gpu()
    W = 4
    gen = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((B, W * shard, 3 * H * hd), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.view(B, W * shard, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    before = dict(ra.LAUNCHES)
    got = ra.ring_by_rank(q, k, v, do, world=W, causal=causal)
    n = W * (W + 1) // 2 if causal else W * W
    assert {m: ra.LAUNCHES[m] - before[m] for m in before} == {
        "ring_attention_fwd": n, "ring_attention_bwd": n}
    o, lse = ra.ring_forward(q, k, v, world=W, causal=causal)
    folded = (o, lse) + ra.ring_backward(q, k, v, o, lse, do, world=W,
                                         causal=causal)
    for a, b in zip(got, folded):
        assert torch.equal(a, b)
    plain = ra.ring_by_rank(q, k, v, do, world=W, causal=causal, plain=True)
    assert (got[0] - plain[0]).abs().max().item() <= 2e-2
    assert (got[1] - plain[1]).abs().max().item() <= 1e-3
    for g, r in zip(got[2:], plain[2:]):
        assert torch.isfinite(g).all() and _rel(g, r) <= 2e-2


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


@pytest.mark.cuda
@pytest.mark.parametrize("consumer_ms", [0, 20])
def test_device_batch_iterator_bytes_equal_host_batches_on_gpu(consumer_ms):
    """``DeviceBatchIterator`` stages each batch in pinned buffers that are
    reused in turn and copies them on a side stream: every device batch,
    read back, must equal its host batch byte for byte, with a consumer
    that takes each batch at once and one slower than the copy (a buffer
    reused before its copy finished would corrupt a later batch
    silently)."""
    _need_gpu()
    import time

    import numpy as np

    from ray_tpu_torch.data.ingest import DeviceBatchIterator

    rng = np.random.default_rng(0)
    host = [{"tokens": rng.integers(0, 50257, (16, 1025), dtype=np.int64),
             "w": rng.standard_normal((16, 4096)).astype(np.float32),
             "name": np.asarray([f"b{i}"] * 16, dtype=object)}
            for i in range(12)]
    it = DeviceBatchIterator(iter(host), device="cuda:0")
    got = []
    for batch in it:
        assert batch["tokens"].is_cuda and batch["w"].is_cuda
        assert batch["name"] is not None and batch["name"].dtype == object
        # Work on the consumer's stream, then a read-back through it.
        got.append({k: (v * 1).cpu().numpy() if isinstance(v, torch.Tensor)
                    else v for k, v in batch.items()})
        time.sleep(consumer_ms / 1000)
    assert len(got) == len(host)
    for h, g in zip(host, got):
        assert g["tokens"].tobytes() == h["tokens"].tobytes()
        assert g["w"].tobytes() == h["w"].tobytes()
        assert list(g["name"]) == list(h["name"])


@pytest.mark.cuda
def test_thread_ranks_allreduce_off_other_streams_on_gpu():
    """Two thread ranks on one card: rank 0's batches come off
    ``DeviceBatchIterator``'s side stream and its contribution is made on a
    stream of its own behind a long device sleep; rank 1 works on the
    default stream. The op must wait for each contributor's stream (and
    each rank for the op's), so every round equals the host's sum; an op
    that read rank 0's tensor early would sum stale bytes."""
    _need_gpu()
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ray_tpu_torch.collective.thread_group import ThreadCollectiveGroup
    from ray_tpu_torch.data.ingest import DeviceBatchIterator

    rng = np.random.default_rng(0)
    rounds = [[rng.standard_normal((4, 1 << 20)).astype(np.float32)
               for _ in range(2)] for _ in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # 2 ranks, 1 card
        group = ThreadCollectiveGroup("side-streams", 2,
                                      devices=[torch.device("cuda", 0)])

    def rank0():
        out = []
        side = torch.cuda.Stream()
        batches = DeviceBatchIterator(({"x": r[0]} for r in rounds),
                                      device="cuda:0")
        for batch in batches:
            with torch.cuda.stream(side):
                side.wait_stream(torch.cuda.current_stream())
                torch.cuda._sleep(200_000_000)
                y = torch.zeros_like(batch["x"])
                y.copy_(batch["x"])
                out.append(group.allreduce(0, y * 2 + 1).cpu())
        return out

    def rank1():
        return [group.allreduce(1, torch.from_numpy(r[1]).cuda()).cpu()
                for r in rounds]

    with ThreadPoolExecutor(2) as pool:
        f0, f1 = pool.submit(rank0), pool.submit(rank1)
        outs = [f0.result(timeout=120), f1.result(timeout=120)]
    for i, (a, b) in enumerate(rounds):
        want = torch.from_numpy(a * 2 + 1 + b)
        for out in outs:
            assert torch.equal(out[i], want), i


@pytest.mark.cuda
def test_world_one_nccl_group_allreduces_on_gpu():
    """A process group of one rank still initialises NCCL on the card, and
    the collective API's op is its all_reduce there."""
    _need_gpu()
    from ray_tpu_torch import collective
    from ray_tpu_torch.collective import distributed
    from ray_tpu_torch.train.trainer import _reserve_addr

    backend = distributed.initialize(_reserve_addr(), 1, 0)
    try:
        assert backend == "nccl" == torch.distributed.get_backend()
        collective.init_collective_group(1, 0, group_name="nccl-1")
        group = collective.get_collective_group("nccl-1")
        assert type(group).__name__ == "ProcessCollectiveGroup"
        x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
        out = collective.allreduce(x, group_name="nccl-1")
        assert out.is_cuda and torch.equal(out, x)
        assert group.ops == {"allreduce": 1}
        with pytest.raises(ValueError, match="process group is NCCL"):
            collective.init_collective_group(1, 0, backend="gloo",
                                             group_name="gloo-1")
    finally:
        collective.destroy_collective_group("nccl-1")
        distributed.shutdown()


@pytest.mark.cuda
def test_snapshot_reads_what_the_compute_stream_wrote_on_gpu():
    """``snapshot_to_host`` copies CUDA leaves (fp32, bf16, a transposed
    view, int64) into page-locked buffers from its pool, on a side stream
    that waits for the caller's stream: a leaf written by a long queue of
    work on a side compute stream is copied after that work, bit for bit;
    the pool page-locks both its buffers at the first snapshot, and the
    next snapshots reuse them."""
    _need_gpu()
    from ray_tpu_torch.checkpoint.writer import PinnedPool, snapshot_to_host

    gen = torch.Generator(device="cuda").manual_seed(5)
    tree = {"w": torch.randn(1024, 77, generator=gen, device="cuda"),
            "mu": torch.randn(33, 9, generator=gen,
                              device="cuda").to(torch.bfloat16),
            "t": torch.randn(64, 48, generator=gen, device="cuda").t(),
            "i": torch.arange(5, device="cuda"), "count": 3}
    want_w = tree["w"].cpu() + 1
    pool = PinnedPool()
    made = []
    allocate = pool._allocate
    pool._allocate = lambda nbytes: made.append(nbytes) or allocate(nbytes)
    compute = torch.cuda.Stream()
    compute.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(compute):
        big = torch.randn(4096, 4096, generator=gen, device="cuda")
        for _ in range(20):  # keeps the stream busy past the snapshot call
            big = big @ big
            big = big / big.abs().max()
        tree["w"].add_(big[:1024, :77].isfinite().float())
        host, lease = snapshot_to_host(tree, pool)
    compute.synchronize()
    assert torch.equal(host["w"], want_w)
    for k in ("w", "mu", "t", "i"):
        assert host[k].is_pinned() and host[k].dtype == tree[k].dtype
        assert torch.equal(host[k], tree[k].cpu()), k
    assert host["count"] == 3 and len(made) == 2
    pool.release(lease)
    for _ in range(3):
        again, lease = snapshot_to_host(tree, pool)
        assert torch.equal(again["mu"], tree["mu"].cpu())
        pool.release(lease)
    assert len(made) == 2


@pytest.mark.cuda
def test_function_trials_share_the_card_on_gpu():
    """Two {"GPU": 0.5} function trials of a two-layer GPT-2 at full width
    run at once on the card: each trial's thread is granted card 0
    (``granted_cuda_device()`` reads its lease), trains there through the
    splash and fused CE kernels, and reports finite losses."""
    _need_gpu()
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch._private.device import granted_cuda_device
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map

    cfg = gpt2.GPTConfig(n_layer=2, loss_impl="fused",
                         remat_policy="attn_outside", scan_layers=False)
    tokens = np.random.default_rng(0).integers(
        0, 50257, (2, cfg.seq_len + 1), dtype=np.int64)

    def trial(config):
        dev = granted_cuda_device()
        torch.cuda.set_device(dev)
        params = gpt2.init_params(cfg, seed=0, device=dev)
        optimizer = gpt2.make_optimizer(config["lr"])
        state = optimizer.init(params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tok = torch.as_tensor(tokens, device=dev)
        for _ in range(3):
            loss = gpt2.loss_fn(params, tok[:, :-1], tok[:, 1:], cfg)
            it = iter(torch.autograd.grad(loss, leaves))
            state = optimizer.update(tree_map(lambda _: next(it), params),
                                     state, params)
            tune.report({"loss": float(loss.detach()), "device": str(dev),
                         "gpu_ids": ray_tpu_torch.get_gpu_ids()})

    before = attention.LAUNCHES["splash_attention_fwd"]
    ce_before = fused_ce.LAUNCHES["fused_ce_fwd"]
    ray_tpu_torch.init(num_cpus=4)
    try:
        grid = tune.Tuner(
            trial, param_space={"lr": tune.grid_search([1e-4, 1e-3])},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        trial_resources={"GPU": 0.5})).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert grid.num_errors == 0, grid.errors
    for r in grid:
        reports = [m for m in r.metrics_history if "loss" in m]
        losses = [m["loss"] for m in reports]
        assert len(losses) == 3 and np.isfinite(losses).all(), losses
        assert {(m["device"], tuple(m["gpu_ids"])) for m in reports} == \
            {("cuda:0", (0,))}
    assert attention.LAUNCHES["splash_attention_fwd"] - before == \
        2 * 3 * cfg.n_layer
    assert fused_ce.LAUNCHES["fused_ce_fwd"] - ce_before == 2 * 3


# A workflow's steps, importable so that ``dag.pkl`` names them.
_SEEN_ON_GPU = []


def _attention_on_gpu():
    """A step's value made on the card by the splash kernel."""
    from ray_tpu_torch._private.device import granted_cuda_device

    dev = granted_cuda_device()
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    o = attention.splash_attention(q, k, v, causal=True)
    _SEEN_ON_GPU.append(("made", o.detach().clone()))
    return {"o": o, "device": str(o.device)}


def _consume_on_gpu(value):
    o = value["o"]
    _SEEN_ON_GPU.append(("used", str(o.device), o.dtype, o.clone()))
    if sum(s[0] == "used" for s in _SEEN_ON_GPU) == 1:
        raise RuntimeError("fail the first run")
    return {"sum": o.float().sum().item(), "device": str(o.device)}


@pytest.mark.cuda
def test_resumed_step_gets_its_input_as_in_a_first_run_on_gpu(tmp_path):
    """The workflow device rule (workflow/api.py): a step's CUDA tensor
    reaches the next step on the host, in the first run (through the object
    store) and after a resume (read from ``steps/<id>.pkl``) alike, equal
    bit for bit to what the kernel wrote."""
    _need_gpu()
    import ray_tpu_torch
    from ray_tpu_torch import workflow

    del _SEEN_ON_GPU[:]
    workflow.init_storage(str(tmp_path))
    ray_tpu_torch.init(num_cpus=2)
    try:
        make = ray_tpu_torch.remote(num_gpus=1)(_attention_on_gpu)
        use = ray_tpu_torch.remote(num_gpus=1)(_consume_on_gpu)
        dag = use.bind(make.bind())
        with pytest.raises(Exception, match="fail the first run"):
            workflow.run(dag, workflow_id="gpu-rule")
        out = workflow.resume("gpu-rule")
    finally:
        ray_tpu_torch.shutdown()
    made = [s for s in _SEEN_ON_GPU if s[0] == "made"]
    used = [s for s in _SEEN_ON_GPU if s[0] == "used"]
    assert len(made) == 1 and len(used) == 2  # the first step ran once
    want = made[0][1]
    assert want.is_cuda
    for _, device, dtype, got in used:
        assert (device, dtype) == ("cpu", torch.bfloat16)
        assert torch.equal(got, want.cpu())
    # Summed on the host, as the step summed it.
    assert out == {"sum": want.cpu().float().sum().item(), "device": "cpu"}


@pytest.mark.cuda
def test_step_value_read_back_from_its_checkpoint_on_gpu(tmp_path):
    """A step's CUDA output is written to its checkpoint as a host copy:
    the file, the workflow's output and ``get_output`` after a restart of
    the runtime give the kernel's bits back on the host."""
    _need_gpu()
    import os

    import ray_tpu_torch
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.workflow import api

    del _SEEN_ON_GPU[:]
    workflow.init_storage(str(tmp_path))
    ray_tpu_torch.init(num_cpus=2)
    try:
        dag = ray_tpu_torch.remote(num_gpus=1)(_attention_on_gpu).bind()
        out = workflow.run(dag, workflow_id="gpu-ckpt")
        sid = api._step_ids(dag)[id(dag)]
    finally:
        ray_tpu_torch.shutdown()
    want = _SEEN_ON_GPU[0][1].cpu()
    with open(os.path.join(str(tmp_path), "gpu-ckpt", "steps",
                           f"{sid}.pkl"), "rb") as f:
        stored = serialization.loads(f.read())
    ray_tpu_torch.init(num_cpus=2)
    try:
        again = workflow.get_output("gpu-ckpt")
    finally:
        ray_tpu_torch.shutdown()
    for value in (out, stored, again):
        assert value["device"] == "cuda:0"  # where the step made it
        assert value["o"].device.type == "cpu"
        assert torch.equal(value["o"], want)


@pytest.mark.cuda
def test_virtual_nodes_sharing_card_zero_each_grant_it_on_gpu():
    """Two virtual nodes, each half of card 0: an actor placed on each (by
    node affinity) reads ``cuda:0`` from its lease and allocates there."""
    _need_gpu()
    import ray_tpu_torch
    from ray_tpu_torch._private.device import granted_cuda_device
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        nodes = [cluster.add_node(num_cpus=1, num_gpus=0.5)
                 for _ in range(2)]

        @ray_tpu_torch.remote(num_gpus=0.5)
        class Rank:
            def card(self):
                dev = granted_cuda_device()
                x = torch.ones(4, device=dev)
                return str(dev), str(x.device), ray_tpu_torch.get_gpu_ids()

        ranks = [Rank.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            str(n))).remote() for n in nodes]
        assert ray_tpu_torch.get([r.card.remote() for r in ranks],
                                 timeout=60) == [("cuda:0", "cuda:0", [0])] * 2
    finally:
        cluster.shutdown()


@pytest.mark.cuda
def test_add_node_refuses_a_card_the_host_lacks_on_gpu():
    _need_gpu()
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"host has {n}"):
            cluster.add_node(num_gpus=0.5, gpu_index=n)
        cluster.add_node(num_gpus=0.5, gpu_index=n - 1)
    finally:
        cluster.shutdown()


@pytest.mark.cuda
def test_preempted_thread_rank_memory_comes_back_on_gpu(tmp_path):
    """A two-rank elastic fit over two half-card nodes; one node is
    preempted mid-run. Its rank's thread ends at its next boundary and the
    card memory it held comes back: after the fit, ``memory_allocated()``
    (cuBLAS workspaces cleared) is within 64 MB of its value before."""
    _need_gpu()
    import gc
    import threading
    import time

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.train import (CheckpointConfig, CudaTrainer,
                                     ElasticConfig, RunConfig, ScalingConfig,
                                     run_registry)

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        nodes = [cluster.add_node(num_cpus=1, num_gpus=0.5)
                 for _ in range(2)]
        rows = np.random.default_rng(0).integers(
            0, 50257, (64, 1025), dtype=np.int64)
        def allocated():
            # Each thread's cuBLAS handle keeps a 32 MiB workspace after
            # the thread ends: cleared, so that only tensors count.
            gc.collect()
            torch.cuda.synchronize()
            torch._C._cuda_clearCublasWorkspaces()
            return torch.cuda.memory_allocated()

        before = allocated()
        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=dict(batch_size=2, ckpt_every=2,
                                   async_save=True, seed=0),
            scaling_config=ScalingConfig(
                num_workers=2, gpus_per_worker=0.5, worker_mode="threads",
                elastic=ElasticConfig(min_workers=1)),
            datasets={"train": rows},
            run_config=RunConfig(
                name="preempt-memory", storage_path=str(tmp_path),
                checkpoint_config=CheckpointConfig(async_save=True)))
        box = {}
        t = threading.Thread(target=lambda: box.update(r=trainer.fit()),
                             daemon=True)
        t.start()
        deadline = time.monotonic() + 300
        while (run_registry.get_run("preempt-memory") or {}).get(
                "last_committed_step") is None:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert simulate_preemption(str(nodes[1])) is not None
        t.join(timeout=600)
        assert not t.is_alive() and box["r"].error is None, box.get("r")
        del box, trainer
        after = allocated()
        assert after - before <= 64 << 20, (before, after)
    finally:
        cluster.shutdown()


def _llama_qkv(B, S, H, KV, hd, seed):
    """q, k, v as the Llama block makes them: RoPE'd q and k from their
    own projections, k and v repeated per query group (``repeat_interleave``
    on the head axis), all contiguous bf16. Returns the pre-repeat leaves
    too, for the gradient."""
    from ray_tpu_torch.models import llama

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q0, k0, v0 = (torch.randn((B, S, n, hd), generator=gen, device="cuda",
                              dtype=torch.bfloat16, requires_grad=True)
                  for n in (H, KV, KV))
    q, k = llama._rope(q0, 10000.0), llama._rope(k0, 10000.0)
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v0))
    return (q0, k0, v0), (q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 2])
def test_splash_kernels_at_llama_gqa_shapes_on_gpu(B):
    """LlamaConfig()'s attention: 8 query heads over 4 kv heads of 64, S=1024,
    q and k fresh from RoPE and k, v repeat_interleave copies. The forward
    kernel against the plain version (o within 2e-2, lse 1e-3), and the
    backward kernel's gradient, through RoPE and the repeat into the
    pre-repeat leaves, against autograd through the plain version in fp32
    (within 2e-2 of each leaf's largest entry)."""
    _need_gpu()
    H, KV, S, hd = 8, 4, 1024, 64
    leaves, (q, k, v) = _llama_qkv(B, S, H, KV, hd, seed=7)
    do = torch.randn((B, S, H, hd), generator=torch.Generator(
        device="cuda").manual_seed(8), device="cuda", dtype=torch.bfloat16)
    before = dict(attention.LAUNCHES)
    o, lse = attention.splash_attention(q, k, v, return_lse=True)
    grads = torch.autograd.grad(o, leaves, do)
    assert attention.LAUNCHES == {
        "splash_attention_fwd": before["splash_attention_fwd"] + 1,
        "splash_attention_bwd": before["splash_attention_bwd"] + 1}
    o_ref, lse_ref = attention.attention_reference(q, k, v)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    f32 = [x.detach().float().requires_grad_(True) for x in leaves]
    from ray_tpu_torch.models import llama

    qf, kf = llama._rope(f32[0], 10000.0), llama._rope(f32[1], 10000.0)
    kf, vf = (t.repeat_interleave(H // KV, dim=2) for t in (kf, f32[2]))
    ref = torch.autograd.grad(
        attention.attention_reference(qf, kf, vf)[0], f32, do.float())
    for g, r in zip(grads, ref):
        assert torch.isfinite(g).all() and _rel(g, r) <= 2e-2


@pytest.mark.cuda
def test_llama_step_goes_through_the_splash_kernels_on_gpu():
    """A B=2 loss and gradient of LlamaConfig() (8 layers, whole-layer
    remat): 16 splash forwards and 8 backwards, no ring or CE launch, the
    loss within 1e-3 and every gradient leaf within 5e-2 of its largest
    entry against plain attention (chip_smoke.py's gates)."""
    _need_gpu()
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.optim import tree_leaves, tree_map

    config = llama.LlamaConfig()
    init = llama.init_params(config, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, config.vocab_size, (2, config.seq_len + 1),
                         generator=gen, device="cuda")

    def run(cfg):
        params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                          init)
        loss = llama.loss_fn(params, toks[:, :-1], toks[:, 1:], cfg)
        return float(loss), torch.autograd.grad(loss, tree_leaves(params))

    counts = [attention.LAUNCHES, fused_ce.LAUNCHES, ra.LAUNCHES]
    before = [dict(c) for c in counts]
    loss, grads = run(config)
    delta = {k: v - b[k] for c, b in zip(counts, before) for k, v in c.items()}
    assert delta == {"splash_attention_fwd": 16, "splash_attention_bwd": 8,
                     **{k: 0 for k in fused_ce.LAUNCHES},
                     **{k: 0 for k in ra.LAUNCHES}}
    ref_loss, ref = run(dataclasses.replace(config, attn_impl="xla"))
    assert abs(loss - ref_loss) <= 1e-3
    for g, r in zip(grads, ref):
        assert _rel(g, r) <= 5e-2


@pytest.mark.cuda
def test_ppo_runner_and_learner_on_gpu():
    """RL has no kernel of its own: the runner's batched forward and one
    PPO update on the card, against the same on the CPU from the same
    weights (chip_smoke.py's RL_ATOL; the runner's noise comes from a host
    generator, so the steps are the same), and no port kernel launched."""
    _need_gpu()
    import numpy as np

    from ray_tpu_torch.rl import (DefaultActorCritic, RLModuleSpec,
                                  SingleAgentEnvRunner)
    from ray_tpu_torch.rl.algorithms import PPOConfig, PPOLearner
    from ray_tpu_torch.rl.core.rl_module import Columns

    counts = [attention.LAUNCHES, fused_ce.LAUNCHES, ra.LAUNCHES]
    before = [dict(c) for c in counts]
    spec = RLModuleSpec(module_class=DefaultActorCritic, observation_dim=4,
                        action_dim=2)
    runs = {}
    for dev in ("cpu", "cuda"):
        runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=spec,
                                      num_envs=4, device=dev)
        assert next(runner.module.parameters()).device.type == dev
        runs[dev] = [e.to_numpy() for e in runner.sample(num_timesteps=64)]
    assert sum(len(e["actions"]) for e in runs["cuda"]) == 64
    assert len(runs["cpu"]) == len(runs["cuda"])
    for a, b in zip(runs["cpu"], runs["cuda"]):
        for k in ("obs", "actions", "rewards"):
            assert np.array_equal(a[k], b[k]), k
        assert np.abs(a["action_logp"] - b["action_logp"]).max() <= 1e-5
    rng = np.random.default_rng(0)
    n = 128
    batch = {Columns.OBS: rng.normal(size=(n, 4)).astype(np.float32),
             Columns.ACTIONS: rng.integers(0, 2, n).astype(np.int32),
             Columns.ACTION_LOGP: np.full(n, -0.6, np.float32),
             Columns.ADVANTAGES: rng.normal(size=n).astype(np.float32),
             Columns.VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
             "kl_coeff": np.float32(0.2)}
    weights = {}
    for dev in ("cpu", "cuda"):
        learner = PPOLearner(config=PPOConfig().training(grad_clip=0.5)
                             .resources(device=dev), module_spec=spec, seed=0)
        learner.update_from_batch(dict(batch), num_epochs=2, minibatch_size=32)
        weights[dev] = learner.get_weights()
    for k, w in weights["cpu"].items():
        assert (weights["cuda"][k].cpu() - w).abs().max().item() <= 1e-5, k
    delta = {k: v - b[k] for c, b in zip(counts, before) for k, v in c.items()}
    assert not any(delta.values())


@pytest.mark.cuda
def test_sac_update_on_gpu_matches_the_cpu():
    """RL's three-optimizer step: one CQL update (SAC's step and CQL's
    penalty) on the card against the same on the CPU, from the same weights
    and with the same noise injected in place of each learner's draw: every
    weight within chip_smoke.py's SAC_ATOL, and no port kernel launched."""
    _need_gpu()
    import numpy as np

    from ray_tpu_torch.rl.algorithms import CQLConfig, CQLLearner
    from ray_tpu_torch.rl.algorithms.sac import SACModule
    from ray_tpu_torch.rl.core.rl_module import Columns, RLModuleSpec

    counts = [attention.LAUNCHES, fused_ce.LAUNCHES, ra.LAUNCHES]
    before = [dict(c) for c in counts]
    spec = RLModuleSpec(module_class=SACModule, observation_dim=3,
                        action_dim=1, discrete=False,
                        model_config={"action_scale": 2.0})
    rng = np.random.default_rng(0)
    n = 256
    batch = {Columns.OBS: rng.normal(size=(n, 3)).astype(np.float32),
             Columns.ACTIONS: rng.uniform(-2, 2, (n, 1)).astype(np.float32),
             Columns.REWARDS: rng.normal(size=n).astype(np.float32),
             Columns.NEXT_OBS: rng.normal(size=(n, 3)).astype(np.float32),
             Columns.TERMINATEDS: (rng.random(n) < 0.1).astype(np.float32)}
    gen = torch.Generator().manual_seed(1)
    noise = {"next": torch.randn((n, 1), generator=gen),
             "new": torch.randn((n, 1), generator=gen),
             "rand": torch.rand((4, n, 1), generator=gen) * 4 - 2,
             "pi": torch.randn((4, n, 1), generator=gen)}
    weights = {}
    for dev in ("cpu", "cuda"):
        learner = CQLLearner(config=CQLConfig().resources(device=dev),
                             module_spec=spec, seed=0)
        learner._draw_noise = lambda b, dev=dev: {
            k: v.to(dev) for k, v in noise.items()}
        learner.update_from_batch(dict(batch))
        weights[dev] = learner.module.state_dict()
    for k, w in weights["cpu"].items():
        assert (weights["cuda"][k].cpu() - w).abs().max().item() <= 1e-4, k
    delta = {k: v - b[k] for c, b in zip(counts, before) for k, v in c.items()}
    assert not any(delta.values())


@pytest.mark.cuda
def test_dreamer_updates_on_gpu_match_the_cpu():
    """DreamerV3's world-model and actor-critic updates on the card against
    the same on the CPU, from the same weights (drawn on the host from one
    seed), batch and Gumbel noise: every weight and the target critic
    within chip_smoke.py's RL_ATOL, and no port kernel launched."""
    _need_gpu()
    import numpy as np

    from ray_tpu_torch.rl.algorithms import DreamerV3Config

    counts = [attention.LAUNCHES, fused_ce.LAUNCHES, ra.LAUNCHES]
    before = [dict(c) for c in counts]
    B, T, H, S, C, A = 4, 8, 5, 4, 4, 2
    rng = np.random.default_rng(0)
    first = (rng.random((B, T)) < 0.2).astype(np.float32)
    first[:, 0] = 1.0
    batch = {"obs": rng.normal(0, 1, (B, T, 4)).astype(np.float32),
             "actions": rng.integers(0, A, (B, T)).astype(np.int32),
             "rewards": rng.normal(0, 1, (B, T)).astype(np.float32),
             "terminateds": (rng.random((B, T)) < 0.1).astype(np.float32),
             "is_first": first}
    gen = torch.Generator().manual_seed(1)

    def gumbel(*shape):
        u = torch.rand(shape, generator=gen).clamp_min(1e-30)
        return -torch.log(-torch.log(u))

    noise = [{"z": gumbel(T, B, S, C)},
             {"action": gumbel(H, B * T, A), "z": gumbel(H, B * T, S, C)}]
    states = {}
    for dev in ("cpu", "cuda"):
        algo = (DreamerV3Config().environment("CartPole-v1")
                .training(deter_dim=32, hidden=32, stoch_groups=S,
                          stoch_classes=C, batch_size=B, batch_length=T,
                          horizon=H)
                .resources(device=dev).debugging(seed=0).build_algo())
        draws = iter(noise)
        algo._draw_noise = lambda site, *lead, it=draws, dev=dev: {
            k: v.to(dev) for k, v in next(it).items()}
        _, _, feat = algo._wm_update({k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()})
        algo._ac_update(feat.reshape(-1, feat.shape[-1]), 1.0)
        states[dev] = {**algo.model.state_dict(),
                       **{f"target.{k}": v for k, v in
                          algo.target_critic.state_dict().items()}}
    for k, w in states["cpu"].items():
        assert (states["cuda"][k].cpu() - w).abs().max().item() <= 1e-5, k
    delta = {k: v - b[k] for c, b in zip(counts, before) for k, v in c.items()}
    assert not any(delta.values())


@pytest.mark.cuda
def test_device_memory_snapshot_reads_the_card():
    """One row per visible card, its figures those of
    ``torch.cuda.memory_stats`` and ``mem_get_info``."""
    _need_gpu()
    from ray_tpu_torch.util import device_telemetry as dt

    x = torch.empty(1 << 20, device="cuda")
    torch.cuda.synchronize()
    rows = dt.device_memory_snapshot()
    assert len(rows) == torch.cuda.device_count()
    assert rows[0]["platform"] == "gpu" and rows[0]["device"] == "0"
    assert rows[0]["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert rows[0]["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    assert rows[0]["peak_bytes_in_use"] >= x.numel() * 4


def _gloo_rank(rank, world, port, out):
    """One of ``world`` gloo processes on card 0: an all-reduce of a CUDA
    tensor, and a DTensor on a "cuda" mesh redistributed Partial ->
    Shard(0) (a reduce-scatter) and Partial -> Replicate (an all-reduce),
    the redistributions of a data mesh's gradient sync. (Shard ->
    Replicate, the functional all-gather, kills a gloo rank on CUDA
    tensors: scripts/torch_gloo_cuda_probe.py.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ray_tpu_torch.parallel import MeshSpec, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        mesh = make_mesh(MeshSpec(data=world))  # the card, by default
        x = torch.arange(2 * world, dtype=torch.float32, device="cuda")
        part = DTensor.from_local(x * (rank + 1), mesh.device_mesh,
                                  [Partial()])
        shard = part.redistribute(mesh.device_mesh, [Shard(0)])
        whole = part.redistribute(mesh.device_mesh, [Replicate()])
        out.put((rank, t.tolist(), shard.to_local().tolist(),
                 whole.to_local().tolist(), str(whole.to_local().device)))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_ranks_share_one_card_on_gpu():
    """Two gloo processes on card 0 (NCCL refuses two ranks on one device):
    an all-reduce of a CUDA tensor and a DTensor redistribution on a
    "cuda" device mesh, the path of chip_smoke.py's train_mesh."""
    _need_gpu()
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    for _ in range(2):
        rank, *rest = out.get(timeout=120)
        got[rank] = rest
    for p in procs:
        p.join(60)
    total = [3.0 * v for v in range(4)]
    for rank, (reduced, shard, whole, device) in got.items():
        assert reduced == [3.0] * 4
        assert shard == total[2 * rank:2 * rank + 2]
        assert whole == total and device == "cuda:0"


@pytest.mark.cuda
def test_device_channel_hands_a_card_tensor_over_as_is_on_gpu():
    """A tensor already on the channel's card crosses the edge with its
    storage (the same ``data_ptr``), and no transfer is ledgered; a host
    tensor lands on the card as an h2d transfer of its bytes."""
    _need_gpu()
    from ray_tpu_torch.dag import DeviceChannel
    from ray_tpu_torch.util import device_telemetry as dt

    dt.reset()
    ch = DeviceChannel(device="cuda", maxsize=2)
    x = torch.randn((4, 1024), device="cuda")
    ch.write({"x": x, "host": torch.ones(256)})
    assert dt.pool_bytes()["dag_channel"]["bytes"] == 4 * 4096 + 1024
    out = ch.read()
    assert out["x"].data_ptr() == x.data_ptr() and out["x"].is_cuda
    assert out["host"].device == torch.device("cuda", 0)
    assert out["host"].sum().item() == 256.0
    assert dt.pool_bytes()["dag_channel"]["bytes"] == 0
    moved = [r for r in dt.transfer_records() if r["src"] == "dag_channel"]
    assert [(r["direction"], r["bytes"]) for r in moved] == [("h2d", 1024)]
    # And back to the host: a d2h transfer, read once the copy is done.
    back = DeviceChannel(device="cpu")
    back.write(x)
    assert torch.equal(back.read(), x.cpu())
    assert [r["direction"] for r in dt.transfer_records()
            if r["src"] == "dag_channel"] == ["h2d", "d2h"]


@pytest.mark.cuda
def test_device_channel_orders_a_side_stream_producer_on_gpu():
    """The producer fills its tensor on a side stream after a long device
    sleep; the consumer reads on its default stream. Without the channel's
    event wait the consumer's sum would run before the fill."""
    _need_gpu()
    from ray_tpu_torch.dag import DeviceChannel

    ch = DeviceChannel(device="cuda")
    side = torch.cuda.Stream()
    n = 1 << 22
    with torch.cuda.stream(side):
        x = torch.zeros(n, device="cuda")
        torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
        x.fill_(1.0)
        ch.write(x)
    total = ch.read().sum()  # on the default stream
    assert total.item() == float(n)


@pytest.mark.cuda
def test_compiled_split_launches_one_splash_forward_per_layer_on_gpu():
    """GPT-2 split over two thread actors on the card and compiled: the
    logits equal the whole forward's bit for bit, and every execute makes
    exactly one splash forward launch per layer (two per stage here)."""
    _need_gpu()
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve.gpt2 import GPT2Stage

    cfg = gpt2.GPTConfig(vocab_size=1024, n_layer=4, n_head=2, d_model=128,
                         seq_len=256)
    params = gpt2.init_params(cfg, 0, "cuda")
    tokens = np.random.default_rng(0).integers(0, 1024, (2, 256))
    with torch.inference_mode():
        whole = gpt2.forward(gpt2.inference_params(params, cfg),
                             torch.as_tensor(tokens, device="cuda"), cfg)
    ray_tpu_torch.init(num_cpus=4)
    try:
        Stage = ray_tpu_torch.remote(GPT2Stage)
        a = Stage.remote((0, 2), cfg, params=params)
        b = Stage.remote((2, 4), cfg, params=params)
        with InputNode() as inp:
            dag = b.tail.bind(a.head.bind(inp).with_tensor_transport())
        compiled = dag.experimental_compile()
        try:
            compiled.execute(tokens).get(timeout=120)  # builds the kernels
            attention.reset_launches()
            outs = [compiled.execute(tokens).get(timeout=60)
                    for _ in range(3)]
            launches = dict(attention.LAUNCHES)
        finally:
            compiled.teardown()
    finally:
        ray_tpu_torch.shutdown()
    assert launches == {"splash_attention_fwd": 3 * 4,
                        "splash_attention_bwd": 0}
    for out in outs:
        assert out.is_cuda and torch.equal(out, whole)
