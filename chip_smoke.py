#!/usr/bin/env python3
"""Drives the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Prints the card (``nvidia-smi`` name and power limit) and builds every
   kernel under ``ray_tpu_torch/csrc`` from source, timing the build; prints
   each ring kernel's, each splash kernel's and the fused CE kernels'
   registers, spill bytes, shared memory and resident blocks per SM
   (``resources ring ...``, ``resources splash <fwd|dkv|dq> hd=...``,
   ``resources ce <fwd|dx|dw> D=...``; the CE forward's also its cluster
   size and the clusters the card holds at once), and fails if a CE kernel
   spills at D=768 or ptxas serialised their wgmma (a C751x note).
2. Kernels against their plain versions, each at the main path's shape and
   a few edge shapes, with its device time beside the plain version's, a
   PyTorch yardstick (the port never calls it) and the card's bound:
   - the splash attention forward against ``attention_reference`` (output
     and lse; yardstick ``F.scaled_dot_product_attention``);
   - the splash attention backward against ``attention_bwd_reference``
     (dq, dk, dv; yardstick the backward of SDPA, its device time from
     ``torch.profiler`` beside a host-clock loop), timed at the training
     shape and at head_dim 128; it runs after phase 5, so that the
     profiler's tracing cannot slow what the other phases time;
   - the fused LM-head cross-entropy forward, dx and dW against
     ``ce_fwd_reference``, ``ce_dx_reference`` and ``ce_dw_reference``
     (yardstick the dense head: bf16 logits, logsumexp and gather, and
     their backward, the backward also timed on the device by kernel with
     ``torch.profiler``, after every other phase, beside dx + dW; the
     forward's also cuBLAS's bf16 ``x @ W^T`` alone, ``matmul_ms``: the
     forward's tensor-core work without the logsumexp).
3. Serving: GPT-2 124M (``GPTConfig()``, bf16, random weights from a seed)
   answers unary requests through ``GPT2Next`` and streams greedy tokens
   through ``GPT2Stream``. The splash launch counter must rise by exactly
   ``n_layer`` per forward, and every answer is held against the same model
   with ``attn_impl="xla"`` (the plain attention) on the card.
4. Training: GPT-2 124M, ``GPTConfig(remat_policy="attn_outside",
   scan_layers=False)``, ``make_optimizer(3e-4)``, B=16, S=1024, one batch
   from a numpy seed: five steps with the dense loss, then five with
   ``loss_impl="fused"`` from the same start. Every loss is finite and the
   last is below the first; each step launches exactly 12 splash forwards
   and 12 splash backwards, and in the fused run one of each CE kernel. At
   B=2 the loss and every gradient of one step are held against the same
   step with plain attention, the dense loss and ``remat_policy="full"``;
   and ``remat_policy="full"`` on the kernel path launches 24 splash
   forwards (each block's reruns in the backward) for the same gradients.
5. Ring attention (``attn_impl="ring"``, the ``seq`` axis of W=4 ranks
   folded onto the card): the ring step forward and backward kernels
   against their plain versions at the training path's per-step shapes
   (B=16, S_local=256, 12 heads, hd=64), a ragged shard, head_dim 128 and
   the full mask, with per-launch and whole-ring times beside the bound
   (step 0's blocks write-only; ``bound_ms_accumulate`` with every block
   reading) and SDPA, step 0 timed from NaN-filled accumulators, which it
   must not read; whole ``ring_attention`` against ``splash_attention`` at
   (16, 1024, 12, 64), forward and gradient. Then GPT-2 124M trains five
   steps through the ring from the splash run's start (exactly 48 ring
   forward and 48 ring backward launches per step, no splash or CE), and
   one B=2 step of ``attn_impl="ring"`` and of ``"ulysses"`` is held
   against the splash path.
6. Serving through the control plane (``serve_http`` line): after the
   in-process phases, ``ray_tpu_torch.init()`` and ``serve.start`` bring up
   the controller and the HTTP proxy, ``serve.run`` deploys ``GPT2Next``
   and then ``GPT2Stream`` at GPT-2 124M with the serving phase's weights,
   each replica holding the card (``ray_actor_options={"num_gpus": 1}``; the
   node registers one GPU, so the two apps take it in turn), and the phase's
   requests go over HTTP: four unary JSON POSTs and one SSE stream. Every
   answer and every token must equal the in-process one, the SSE answer's
   Content-Type must be ``text/event-stream``, and the splash launches over
   the HTTP requests must be exactly ``n_layer`` per forward. It prints each
   request's HTTP latency beside the in-process one, the SSE gaps and the
   decode rate beside the in-process rate.
7. Batched serving through the control plane (``serve_batch`` line): the
   same weights behind ``GPT2BatchNext`` (``@serve.batch``) beside
   ``GPT2Next``, 64 requests of random lengths from 1, 8 and 32 concurrent
   HTTP clients in turns; ``GPT2ContinuousStream``
   (``@serve.continuous_batch``) streaming 8 SSE answers, half of them
   admitted mid-flight, beside 8 concurrent ``GPT2Stream`` streams; and
   ``GPT2MultiplexNext`` (``@serve.multiplexed``) on two replicas with
   seeds 1 and 2 alternating, then seed 3. Each replica holds half the card.
   It fails if an answer or token breaks the tie rule (its reference logit
   within ``LOGIT_ATOL`` of the reference maximum), if the splash launches
   are not ``n_layer`` per vectorized call, per continuous step or per
   request as each path forms them, if no batch larger than 1 forms at 32
   clients, if the continuous steps are not shared, if the second half of
   the multiplexed traffic loads a model, or if the card does not get the
   evicted model's memory back. It prints queries per second, batch sizes,
   aggregate tokens per second and gaps, loads and memory.
8. Prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. It imports nothing of JAX or of ``ray_tpu``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Tuple

# Published dense peaks, one table for the port (ray_tpu_torch._private.peaks):
# device-memory bytes/s and bf16 tensor-core flop/s by card name.
from ray_tpu_torch._private.peaks import PEAKS, peaks_for  # noqa: E402,F401

# Kernel against plain version, bf16 in and out: the kernel rounds the
# unnormalised probabilities to bf16 before p @ v and normalises in fp32;
# the plain version rounds the normalised ones. Both round o to bf16 (an ulp
# is 2**-8 relative). lse is fp32 on both sides from the same fp32 scores.
O_ATOL = 2e-2
LSE_ATOL = 1e-3
# Served logits (fp32, from a 12-layer bf16 model) against the plain-attention
# model: the two attention paths round differently in bf16, and the
# difference passes through the remaining layers.
LOGIT_ATOL = 5e-2

# (B, S, H, hd, causal): the training shape (B=16), the serving shapes (B=1,
# and batches of 8 and 32 as serve.batch forms them, at S=1024 and at a
# ragged longest request), ragged S, and head_dim 128.
KERNEL_SHAPES = [
    (16, 1024, 12, 64, True),
    (8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
    (32, 1024, 12, 64, True), (8, 517, 12, 64, True),
    (1, 1024, 12, 64, True), (1, 1024, 12, 64, False),
    (1, 1000, 12, 64, True), (2, 1000, 12, 64, False),
    (1, 7, 12, 64, True), (3, 7, 12, 64, False),
    (2, 512, 8, 128, True), (2, 512, 8, 128, False),
]
# The main path's shape (GPT2Stream pads every step to seq_len).
MAIN_SHAPE = (1, 1024, 12, 64, True)

# Splash backward against attention_bwd_reference, per gradient: max|delta|
# over max|reference| (bf16 out). The kernel rounds p and ds to bf16 before
# its products and accumulates in another order; the plain version keeps
# them fp32; both round the result to bf16 (2**-8 relative).
BWD_RTOL = 2e-2
# (B, S, H, hd, causal): the training shape first, q, k, v split from a
# fused qkv as the model makes them. Timed: the training shape and
# head_dim 128.
BWD_SHAPES = [(16, 1024, 12, 64, True), (1, 1000, 12, 64, False),
              (1, 7, 12, 64, True), (2, 512, 8, 128, True)]
BWD_TIMED = [(16, 1024, 12, 64, True), (2, 512, 8, 128, True)]

# Fused CE against its plain versions. lse and tgt are fp32 on both sides
# from exact bf16 products summed in another order (over D and over V).
# dx and dW: both sides round (softmax - onehot) to bf16, and a p that lies
# on a rounding boundary may round one ulp apart (2**-8 relative).
CE_ATOL = 2e-3
CE_GRAD_RTOL = 2e-2
# (N, D, V): GPT-2 124M's training shape (16 x 1024 tokens), the reference
# test's ragged 24 x 96 case, and an N and V (GPT-2's unpadded vocab) that
# are multiples of no tile.
CE_SHAPES = [(16384, 768, 50304), (24, 64, 96), (1000, 768, 50257)]

# Ring kernels (rows 8, 9) against their plain versions: (B, S_local, H, hd,
# causal) over W=4 ranks. The training path's per-step shape first, then a
# ragged shard, head_dim 128 and the full mask. Tolerances are the splash
# kernels' (O_ATOL and LSE_ATOL on the merged fp32 o and lse after W steps,
# BWD_RTOL per gradient): the plain forward rounds each block's o to bf16
# before the merge, as JAX does, where the kernel merges it in fp32.
RING_WORLD = 4
RING_SHAPES = [(16, 256, 12, 64, True), (2, 250, 12, 64, True),
               (2, 256, 8, 128, True), (4, 256, 12, 64, False)]
# Whole ring attention against splash attention on the same q, k, v.
RING_WHOLE_SHAPE = (16, 1024, 12, 64)

TRAIN_BATCH = 16
TRAIN_STEPS = 5
# One B=2 step of the kernel path against the plain-attention, dense-loss,
# full-remat step on the card: loss within LOSS_ATOL; every gradient leaf
# within GRAD_RTOL of its largest entry. The two attention paths round to
# bf16 at different points, and the difference passes through 12 layers.
LOSS_ATOL = 1e-3
GRAD_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def attention_bound(B: int, S: int, H: int, hd: int, causal: bool,
                    bytes_per_s: float, flops_per_s: float
                    ) -> Tuple[float, str]:
    """Least time (ms) for one attention forward, and what bounds it: q, k,
    v read once, o (bf16) and lse (fp32) written once; 4*hd flops for each
    (query, key) pair the mask keeps (q k^T and p v)."""
    nbytes = 4 * B * S * H * hd * 2 + B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * hd * B * H * pairs
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound(B: int, S: int, H: int, hd: int, causal: bool,
                        bytes_per_s: float, flops_per_s: float
                        ) -> Tuple[float, str]:
    """Least time (ms) for one attention backward: q, k, v, o, do read once,
    dq, dk, dv written once (bf16), lse and delta (fp32); 10*hd flops for
    each kept (query, key) pair (the score recompute and the dv, dp, dq, dk
    products)."""
    nbytes = 8 * B * S * H * hd * 2 + 2 * B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10.0 * hd * B * H * pairs
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ring_bound(which: str, B: int, shard: int, H: int, hd: int, n_diag: int,
               n_full: int, bytes_per_s: float, flops_per_s: float,
               n_first: int = 0) -> Tuple[float, str]:
    """Least time (ms) of ring steps that cover n_diag diagonal (causal) and
    n_full full (rank, chunk) blocks of S_local = ``shard`` rows, n_first of
    them at the ring's first step. Per block the forward reads q, k, v
    (bf16) and reads and writes the fp32 o_acc and lse_acc, with 4*hd flops
    per kept (query, key) pair; the backward reads q, k, v, do (bf16), lse
    and delta (fp32) and reads and writes the fp32 dq, dk, dv, with 10*hd
    flops per kept pair. A first-step block writes its accumulators and
    reads none; n_first=0 gives the form in which every block reads them."""
    x, rows = B * shard * H * hd, B * H * shard
    if which == "fwd":
        inputs, acc, flops_per_pair = 3 * x * 2, x * 4 + rows * 4, 4 * hd
    else:
        inputs, acc, flops_per_pair = 4 * x * 2 + 2 * rows * 4, 3 * x * 4, 10 * hd
    pairs = n_diag * shard * (shard + 1) // 2 + n_full * shard * shard
    nbytes = (n_diag + n_full) * (inputs + 2 * acc) - n_first * acc
    flops = float(flops_per_pair) * B * H * pairs
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ce_bound(which: str, N: int, D: int, V: int, bytes_per_s: float,
             flops_per_s: float) -> Tuple[float, str]:
    """Least time (ms) of one fused-CE kernel: x (N, D) and W (V, D) bf16 and
    t (N,) int32 read once; fwd writes lse and tgt (N,) fp32 and does
    2*N*V*D flops; dx and dW also read lse, write (N, D) or (V, D) fp32 and
    recompute the logits, 4*N*V*D flops."""
    nbytes = (N + V) * D * 2 + N * 4
    if which == "fwd":
        nbytes += 2 * N * 4
        flops = 2.0 * N * V * D
    else:
        nbytes += N * 4 + (N if which == "dx" else V) * D * 4
        flops = 4.0 * N * V * D
    t_bytes, t_ops = nbytes / bytes_per_s, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(x, ref) -> float:
    """max|x - ref| / max|ref|, in fp32."""
    return ((x.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3
            ) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn: Callable[[], object], iters: int = 20, reps: int = 5
              ) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed between two events, the median of ``reps`` replays over
    ``iters``. Unlike events around each Python call, this leaves out the
    host's time to launch, which exceeds a small kernel's own time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps + 1):  # the first replay warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times[1:])


class _Request:
    """The two request surfaces the replicas read (JSON body, query params)."""

    def __init__(self, body=None, query_params=None):
        self._body = body
        self.query_params = query_params or {}

    async def json(self):
        return self._body


def loop_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2
            ) -> float:
    """Device time of one call: two events around ``iters`` calls issued back
    to back, over ``iters``. For calls that cannot be captured in a CUDA
    graph (an autograd backward); at the sizes it is used for, the host
    issues the next call long before the device finishes this one."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2
                ) -> Tuple[Optional[float], Dict[str, float]]:
    """Device time of one call: the own times of the CUDA kernels that
    ``torch.profiler`` records over ``iters`` calls, summed, over ``iters``
    (as ``scripts/torch_profile_serve.py:device_kernel_times`` reads them),
    and each kernel's share by name (cut to 80 characters). For calls that
    cannot be captured in a CUDA graph; unlike ``loop_ms`` it leaves out the
    host's gaps between kernels. None when the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key[:80]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.self_device_time_total / 1e3 / iters)
    total = sum(by_kernel.values())
    return (total if total > 0 else None), by_kernel


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_kernel(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst, main = [], 0.0, None
    for B, S, H, hd, causal in KERNEL_SHAPES:
        # q, k, v as the model makes them: views split from one fused qkv.
        qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        o, lse = attention.splash_attention(q, k, v, causal=causal,
                                            return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.attention_reference(q, k, v, causal=causal)
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            fail(f"non-finite kernel output at {(B, S, H, hd, causal)}")
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        worst = max(worst, err_o)
        shape = dict(B=B, S=S, H=H, hd=hd, causal=causal)
        if err_o > O_ATOL or err_lse > LSE_ATOL:
            fail(f"kernel disagrees with attention_reference at {shape}: "
                 f"max|do| {err_o} (tol {O_ATOL}), max|dlse| {err_lse} "
                 f"(tol {LSE_ATOL})")
        def kernel():
            return attention.splash_attention(q, k, v, causal=causal)

        def plain():
            return attention.attention_reference(q, k, v, causal=causal)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        bound_ms, bound_by = attention_bound(B, S, H, hd, causal, *peaks)
        row = dict(shape, max_abs_err=err_o, lse_max_abs_err=err_lse,
                   ms=device_ms(kernel), plain_ms=device_ms(plain, iters=5),
                   library_ms=device_ms(library), bound_ms=bound_ms,
                   bound_by=bound_by, call_ms=time_ms(kernel),
                   library_call_ms=time_ms(library))
        rows.append(row)
        print("kernel splash_attention_fwd " + json.dumps(row), flush=True)
        if (B, S, H, hd, causal) == MAIN_SHAPE:
            main = row
        del qkv, q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return dict(main=main, worst=worst, rows=rows)


def _qkv(gen, B: int, S: int, H: int, hd: int):
    """q, k, v as the model makes them: views split from one fused qkv."""
    import torch

    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    return tuple(t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))


def phase_attn_bwd(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst_abs, worst_rel, main = [], 0.0, 0.0, None
    for n, (B, S, H, hd, causal) in enumerate(BWD_SHAPES):
        q, k, v = _qkv(gen, B, S, H, hd)
        o, lse = attention.splash_attention(q, k, v, causal=causal,
                                            return_lse=True)
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        grads = attention.splash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)
        torch.cuda.synchronize()
        refs = attention.attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal=causal)
        shape = dict(B=B, S=S, H=H, hd=hd, causal=causal)
        row = dict(shape)
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            if not torch.isfinite(g).all():
                fail(f"non-finite splash backward {name} at {shape}")
            row[f"{name}_rel_err"] = rel_err(g, r)
            row[f"{name}_abs_err"] = (g.float() - r.float()).abs().max().item()
            worst_abs = max(worst_abs, row[f"{name}_abs_err"])
            worst_rel = max(worst_rel, row[f"{name}_rel_err"])
            if row[f"{name}_rel_err"] > BWD_RTOL:
                fail(f"splash backward {name} disagrees with "
                     f"attention_bwd_reference at {shape}: "
                     f"{row[f'{name}_rel_err']} (tol {BWD_RTOL})")
        # An external delta (the ring backward's entry) gives the same result.
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
        ext = attention.splash_attention_bwd(q, k, v, o, lse, do,
                                             causal=causal, delta=delta)
        row["external_delta_rel_err"] = max(
            rel_err(a, b) for a, b in zip(ext, grads))
        if row["external_delta_rel_err"] > BWD_RTOL:
            fail(f"splash backward with an external delta differs at {shape}")
        if (B, S, H, hd, causal) in BWD_TIMED:
            qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2).contiguous()

            def kernel():
                return attention.splash_attention_bwd(q, k, v, o, lse, do,
                                                      causal=causal)

            def plain():
                return attention.attention_bwd_reference(q, k, v, o, lse, do,
                                                         causal=causal)

            def library():
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)

            bound_ms, bound_by = attention_bwd_bound(B, S, H, hd, causal,
                                                     *peaks)
            # SDPA's backward is an autograd call, which a CUDA graph does
            # not capture: its device time comes from the profiler (the
            # kernel's own beside it, read the same way), the host-clock
            # loop beside it.
            (library_dev, library_kernels), library_loop = (
                profiled_ms(library), loop_ms(library))
            kernel_dev, kernel_kernels = profiled_ms(kernel)
            row.update(ms=device_ms(kernel), profiled_ms=kernel_dev,
                       profiled_by_kernel=kernel_kernels,
                       library_by_kernel=library_kernels,
                       plain_ms=device_ms(plain, iters=3),
                       library_ms=(library_dev if library_dev is not None
                                   else library_loop),
                       library_ms_by=("profiler" if library_dev is not None
                                      else "events_loop"),
                       library_loop_ms=library_loop, bound_ms=bound_ms,
                       bound_by=bound_by, call_ms=time_ms(kernel))
            if n == 0:
                main = row
            del qt, kt, vt, out, dot
        rows.append(row)
        print("kernel splash_attention_bwd " + json.dumps(row), flush=True)
        del q, k, v, o, lse, do, grads, refs, ext
    torch.cuda.empty_cache()
    return dict(main=main, worst_abs=worst_abs, worst_rel=worst_rel, rows=rows)


def _ce_inputs(gen, N: int, D: int, V: int):
    """x2 (N, D), W (V, D) bf16 and t (N,): layernormed hidden states, GPT-2's
    init scale for the head, uniform targets."""
    import torch

    x2 = torch.randn((N, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    t = torch.randint(0, V, (N,), generator=gen, device="cuda")
    return x2, w, t


def _dense_head(x2, w, t):
    """The dense head on the same inputs: bf16 logits, fp32 logsumexp and
    gather, and the backward of that loss to x2 and W."""
    import torch

    x2d = x2.detach().clone().requires_grad_()
    wd = w.detach().clone().requires_grad_()

    def fwd():
        logits = x2d @ wd.t()
        return (torch.logsumexp(logits.float(), -1)
                - logits.gather(1, t[:, None])[:, 0].float()).mean()

    loss = fwd()

    def bwd():
        return torch.autograd.grad(loss, (x2d, wd), retain_graph=True)

    return fwd, bwd


def phase_ce(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch

    from ray_tpu_torch.ops import fused_ce

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {name: {"rows": [], "worst_abs": 0.0}
           for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")}
    for n, (N, D, V) in enumerate(CE_SHAPES):
        x2, w, t = _ce_inputs(gen, N, D, V)
        lse, tgt = fused_ce.ce_fwd(x2, w, t)
        dx = fused_ce.ce_dx(x2, w, t, lse)
        dw = fused_ce.ce_dw(x2, w, t, lse)
        torch.cuda.synchronize()
        lse_r, tgt_r = fused_ce.ce_fwd_reference(x2, w, t)
        dx_r = fused_ce.ce_dx_reference(x2, w, t, lse)
        dw_r = fused_ce.ce_dw_reference(x2, w, t, lse)
        shape = dict(N=N, D=D, V=V)
        for name, got in (("lse", lse), ("tgt", tgt), ("dx", dx), ("dW", dw)):
            if not torch.isfinite(got).all():
                fail(f"non-finite fused CE {name} at {shape}")
        fwd = dict(shape, lse_abs_err=(lse - lse_r).abs().max().item(),
                   tgt_abs_err=(tgt - tgt_r).abs().max().item())
        fwd["max_abs_err"] = max(fwd["lse_abs_err"], fwd["tgt_abs_err"])
        if fwd["max_abs_err"] > CE_ATOL:
            fail(f"fused_ce_fwd disagrees with ce_fwd_reference at {shape}: "
                 f"{fwd} (tol {CE_ATOL})")
        dxr = dict(shape, rel_err=rel_err(dx, dx_r),
                   max_abs_err=(dx - dx_r).abs().max().item())
        dwr = dict(shape, rel_err=rel_err(dw, dw_r),
                   max_abs_err=(dw - dw_r).abs().max().item())
        for name, r in (("fused_ce_dx", dxr), ("fused_ce_dw", dwr)):
            if r["rel_err"] > CE_GRAD_RTOL:
                fail(f"{name} disagrees with its plain version at {shape}: "
                     f"{r['rel_err']} (tol {CE_GRAD_RTOL})")
        del lse_r, tgt_r, dx_r, dw_r
        if n == 0:  # the training shape: time it
            dense_fwd, dense_bwd = _dense_head(x2, w, t)
            with torch.no_grad():
                dense_fwd_ms = device_ms(dense_fwd, iters=3)
                fwd["matmul_ms"] = device_ms(lambda: x2 @ w.t(), iters=3)
            dense_bwd_ms = loop_ms(dense_bwd, iters=3)
            for r, which, kern, plain in (
                    (fwd, "fwd", lambda: fused_ce.ce_fwd(x2, w, t),
                     lambda: fused_ce.ce_fwd_reference(x2, w, t)),
                    (dxr, "dx", lambda: fused_ce.ce_dx(x2, w, t, lse),
                     lambda: fused_ce.ce_dx_reference(x2, w, t, lse)),
                    (dwr, "dw", lambda: fused_ce.ce_dw(x2, w, t, lse),
                     lambda: fused_ce.ce_dw_reference(x2, w, t, lse))):
                bound_ms, bound_by = ce_bound(which, N, D, V, *peaks)
                r.update(ms=device_ms(kern, iters=3),
                         plain_ms=device_ms(plain, iters=2),
                         dense_ms=dense_fwd_ms if which == "fwd"
                         else dense_bwd_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
            dxr["dx_plus_dw_ms"] = dwr["dx_plus_dw_ms"] = dxr["ms"] + dwr["ms"]
            del dense_fwd, dense_bwd
        for name, r in (("fused_ce_fwd", fwd), ("fused_ce_dx", dxr),
                        ("fused_ce_dw", dwr)):
            out[name]["rows"].append(r)
            out[name]["worst_abs"] = max(out[name]["worst_abs"],
                                         r["max_abs_err"])
            if n == 0:
                out[name]["main"] = r
            print(f"kernel {name} " + json.dumps(r), flush=True)
        del x2, w, t, lse, tgt, dx, dw
        torch.cuda.empty_cache()
    return out


def phase_ce_yardstick(ce: Dict[str, object]) -> Dict[str, object]:
    """The dense head's backward at the CE training shape (phase_ce's
    inputs, from the same seed), timed on the device: the own time of each
    CUDA kernel ``torch.profiler`` records, by name, with cuBLAS's products
    (``matmul_ms``) apart from the softmax and other passes
    (``other_ms``); the host-clock loop beside it, and the fused backward's
    dx + dW from phase_ce. It runs after every other phase, as the splash
    backward's profiled yardstick does."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    x2, w, t = _ce_inputs(gen, *CE_SHAPES[0])
    _, dense_bwd = _dense_head(x2, w, t)
    dev, by_kernel = profiled_ms(dense_bwd, iters=3)
    matmul = sum(ms for name, ms in by_kernel.items()
                 if any(k in name.lower() for k in
                        ("gemm", "xmma", "nvjet", "cutlass")))
    row = dict(N=CE_SHAPES[0][0], D=CE_SHAPES[0][1], V=CE_SHAPES[0][2],
               profiled_ms=dev, matmul_ms=matmul,
               other_ms=(dev - matmul) if dev is not None else None,
               by_kernel=by_kernel, loop_ms=loop_ms(dense_bwd, iters=3),
               dx_plus_dw_ms=ce["fused_ce_dx"]["main"]["dx_plus_dw_ms"])
    print("yardstick ce_dense_bwd " + json.dumps(row), flush=True)
    del x2, w, t, dense_bwd
    torch.cuda.empty_cache()
    return row


# The serving paths' requests: four unary ones of these lengths and one
# 64-token prompt streamed for 16 greedy tokens, from a numpy seed.
SERVE_LENGTHS = (4, 100, 517, 1024)
SERVE_PROMPT_LEN = 64
SERVE_MAX_NEW = 16
# Rounds of HTTP against in-process, in turns, for the cost of the path.
HTTP_ROUNDS = 5


def _serve_requests():
    import numpy as np

    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 50257, n).tolist() for n in SERVE_LENGTHS]
    return requests, rng.integers(0, 50257, SERVE_PROMPT_LEN).tolist()


def serve_weights():
    """GPT-2 124M's weights from seed 0, shared by both serving paths."""
    from ray_tpu_torch.models import gpt2

    return gpt2.init_params(gpt2.GPTConfig(), seed=0, device="cuda")


def phase_serve(params) -> Dict[str, object]:
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import GPT2Next, GPT2Stream

    config = gpt2.GPTConfig()  # GPT-2 124M, bf16, attn_impl="auto"
    nxt = GPT2Next(config, params=params)
    stream = GPT2Stream(config, params=params)
    lengths = SERVE_LENGTHS
    requests, prompt = _serve_requests()
    max_new = SERVE_MAX_NEW

    nxt.next_token(requests[0])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    # The main path: counts at 0 just before, read just after.
    _reset_counts()
    answers, latencies = [], []
    for toks in requests:
        t0 = time.perf_counter()
        out = asyncio.run(nxt(_Request(body={"tokens": toks})))
        latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append(out["next_token"])
    t0 = time.perf_counter()
    streamed, gaps = [], []
    last = t0
    for chunk in stream(_Request(query_params={
            "tokens": ",".join(map(str, prompt)), "max_new": str(max_new)})):
        now = time.perf_counter()
        gaps.append((now - last) * 1e3)
        last = now
        streamed.append(json.loads(chunk)["token"])
    decode_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts["splash_attention_fwd"]

    forwards = len(requests) + max_new
    if launches != config.n_layer * forwards:
        fail(f"splash launches {launches} != n_layer * forwards = "
             f"{config.n_layer} * {forwards}")
    if len(streamed) != max_new:
        fail(f"stream gave {len(streamed)} tokens, wanted {max_new}")

    # Hold every answer against the plain-attention model on the card.
    ref_config = dataclasses.replace(config, attn_impl="xla")
    ref_params = nxt.params
    worst = 0.0

    def check(label, logits, ref, chosen):
        nonlocal worst
        if logits.shape != (config.vocab_size,) or not torch.isfinite(logits).all():
            fail(f"{label}: logits of shape {tuple(logits.shape)} or non-finite")
        err = (logits - ref).abs().max().item()
        worst = max(worst, err)
        gap = (ref.max() - ref[chosen]).item()
        if err > LOGIT_ATOL or gap > LOGIT_ATOL:
            fail(f"{label}: max|dlogit| {err}, chosen token {chosen} is "
                 f"{gap} below the reference max (tol {LOGIT_ATOL})")

    with torch.inference_mode():
        for toks, ans in zip(requests, answers):
            logits = nxt.logits(toks)
            if int(torch.argmax(logits)) != ans:
                fail("GPT2Next answer differs from its own logits' argmax")
            t = torch.tensor([toks], device="cuda")
            ref = gpt2.forward(ref_params, t, ref_config)[0, -1]
            check(f"GPT2Next len {len(toks)}", logits, ref, ans)
        seq = list(prompt)
        for tok in streamed:
            arr = np.zeros((1, config.seq_len), np.int64)
            arr[0, :len(seq)] = seq
            logits = stream.logits_at(arr, len(seq) - 1)
            ref = gpt2.forward(ref_params, torch.as_tensor(arr, device="cuda"),
                               ref_config)[0, len(seq) - 1]
            check(f"GPT2Stream step {len(seq) - len(prompt)}", logits, ref, tok)
            seq.append(tok)

        # Forward time by attention path, and the LM head's two ways.
        full = torch.as_tensor(np.asarray([requests[-1]]), device="cuda")
        fwd_ms = time_ms(lambda: gpt2.forward_hidden(nxt.params, full, config),
                         iters=10)
        fwd_xla_ms = time_ms(lambda: gpt2.forward_hidden(
            nxt.params, full, ref_config), iters=10)
        # The same forward replayed as one CUDA graph: its device time alone.
        fwd_graph_ms = device_ms(lambda: gpt2.forward_hidden(
            nxt.params, full, config), iters=3)
        x = gpt2.forward_hidden(nxt.params, full, config)
        wte = nxt.params["wte"]
        head_fp32_ms = time_ms(lambda: gpt2.lm_head(x, wte, torch.float32),
                               iters=10)
        head_bf16_ms = time_ms(lambda: gpt2.lm_head(x, wte, torch.bfloat16),
                               iters=10)

    result = dict(
        unary_lengths=list(lengths), unary_answers=answers,
        unary_latency_ms=latencies, stream_prompt_len=len(prompt),
        stream_tokens=streamed, stream_gap_ms=gaps,
        decode_tokens_per_s=max_new / decode_s, forwards=forwards,
        splash_launches=launches, launches=counts, max_abs_logit_err=worst,
        forward_hidden_ms_splash=fwd_ms, forward_hidden_ms_xla=fwd_xla_ms,
        forward_hidden_graph_ms_splash=fwd_graph_ms,
        lm_head_ms_fp32_logits=head_fp32_ms,
        lm_head_ms_bf16_logits=head_bf16_ms)
    print("serve " + json.dumps(result), flush=True)
    return result


def _post_json(url: str, body: dict) -> Tuple[int, str, dict]:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers["Content-Type"], json.load(resp)


def _sse(url: str) -> Tuple[int, str, list, list]:
    """One SSE GET: status, Content-Type, the events' JSON, and each
    event's arrival on the host clock."""
    import urllib.request

    req = urllib.request.Request(url, headers={"Accept": "text/event-stream"})
    events, arrivals = [], []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            if raw.startswith(b"data: "):
                arrivals.append(time.perf_counter())
                events.append(json.loads(raw[len(b"data: "):]))
        return resp.status, resp.headers["Content-Type"], events, arrivals


def phase_serve_http(params, inproc: Dict[str, object]) -> Dict[str, object]:
    """The serving path through the control plane: ``serve.run`` deploys
    ``GPT2Next`` and ``GPT2Stream`` at GPT-2 124M, each replica holding the
    card (``num_gpus=1``), and the port's HTTP proxy answers the same
    requests as ``phase_serve``: four unary JSON POSTs and one SSE stream.
    The node registers one GPU, so the two apps take the card in turn: the
    unary app is deleted before the streaming app is deployed. Every answer
    and every token must equal the in-process ones (same weights, same
    deterministic kernel), and the splash launches counted over the HTTP
    requests must be ``n_layer`` per forward: the replicas are threads of
    this process, so the counters are the ones every other phase reads.

    Then the cost of the path: each request again over HTTP and in-process
    (a replica body called on this thread, as ``phase_serve`` calls it), in
    turns, HTTP_ROUNDS times, with every shape already seen; medians."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2

    config = gpt2.GPTConfig()
    requests, prompt = _serve_requests()
    max_new = SERVE_MAX_NEW
    query = f"tokens={','.join(map(str, prompt))}&max_new={max_new}"
    gpu = {"num_gpus": 1}
    local_next = serve.GPT2Next(config, params=params)
    local_stream = serve.GPT2Stream(config, params=params)

    def inproc_unary(toks):
        t0 = time.perf_counter()
        out = asyncio.run(local_next(_Request(body={"tokens": toks})))
        return (time.perf_counter() - t0) * 1e3, out["next_token"]

    def inproc_stream():
        t0 = time.perf_counter()
        arrivals, tokens = [], []
        for chunk in local_stream(_Request(query_params={
                "tokens": ",".join(map(str, prompt)),
                "max_new": str(max_new)})):
            arrivals.append(time.perf_counter())
            tokens.append(json.loads(chunk)["token"])
        return t0, arrivals, tokens

    ray_tpu_torch.init()
    try:
        registered = ray_tpu_torch.cluster_resources().get("GPU")
        if registered != torch.cuda.device_count():
            fail(f"the runtime registers GPU {registered}, torch counts "
                 f"{torch.cuda.device_count()}")
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address
        t0 = time.perf_counter()
        serve.run(serve.deployment(ray_actor_options=gpu)(serve.GPT2Next)
                  .bind(config, params=params), name="gpt2",
                  route_prefix="/gpt2")
        deploy_next_s = time.perf_counter() - t0
        # Warm-up on the replica's threads (cuBLAS handles): not counted.
        _post_json(f"{addr}/gpt2", {"tokens": requests[0]})

        # The main path: counts at 0 just before, read just after.
        _reset_counts()
        answers, latencies, statuses = [], [], set()
        for toks in requests:
            t0 = time.perf_counter()
            status, ctype, out = _post_json(f"{addr}/gpt2", {"tokens": toks})
            latencies.append((time.perf_counter() - t0) * 1e3)
            statuses.add((status, ctype))
            answers.append(out.get("next_token"))
        unary_counts = _counts()

        # Cost of the path: HTTP and in-process in turns, shapes warm.
        http_ms = {n: [] for n in SERVE_LENGTHS}
        inproc_ms = {n: [] for n in SERVE_LENGTHS}
        for _ in range(HTTP_ROUNDS):
            for toks in requests:
                ms, ans = inproc_unary(toks)
                inproc_ms[len(toks)].append(ms)
                t0 = time.perf_counter()
                _, _, out = _post_json(f"{addr}/gpt2", {"tokens": toks})
                http_ms[len(toks)].append((time.perf_counter() - t0) * 1e3)
                if out.get("next_token") != ans:
                    fail(f"HTTP answer {out} != in-process {ans} at length "
                         f"{len(toks)}")

        t0 = time.perf_counter()
        serve.delete("gpt2")
        serve.run(serve.deployment(ray_actor_options=gpu)(serve.GPT2Stream)
                  .bind(config, params=params), name="gpt2stream",
                  route_prefix="/gpt2stream")
        redeploy_s = time.perf_counter() - t0
        _sse(f"{addr}/gpt2stream?tokens=1,2,3&max_new=1")  # warm-up

        _reset_counts()
        t_sse = time.perf_counter()
        sse_status, sse_ctype, events, arrivals = _sse(
            f"{addr}/gpt2stream?{query}")
        stream_counts = _counts()

        rates = {"http": [], "inproc": []}
        gap_runs = {"http": [], "inproc": []}
        for _ in range(HTTP_ROUNDS):
            t0, arr, toks = inproc_stream()
            rates["inproc"].append(max_new / (arr[-1] - t0))
            gap_runs["inproc"].append(_gaps_ms(t0, arr))
            if toks != inproc["stream_tokens"]:
                fail(f"in-process stream {toks} != {inproc['stream_tokens']}")
            t0 = time.perf_counter()
            _, _, evs, arr = _sse(f"{addr}/gpt2stream?{query}")
            rates["http"].append(max_new / (arr[-1] - t0))
            gap_runs["http"].append(_gaps_ms(t0, arr))
            if [e.get("token") for e in evs] != inproc["stream_tokens"]:
                fail(f"SSE tokens {evs} != in-process {inproc['stream_tokens']}")
        serve.delete("gpt2stream")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    counts = {k: unary_counts[k] + stream_counts[k] for k in unary_counts}
    streamed = [e.get("token") for e in events]
    forwards = len(requests) + max_new
    launches = counts["splash_attention_fwd"]
    if statuses != {(200, "application/json; charset=utf-8")}:
        fail(f"unary HTTP answers came back as {statuses}")
    if answers != inproc["unary_answers"]:
        fail(f"HTTP answers {answers} != in-process {inproc['unary_answers']}")
    if sse_status != 200 or not sse_ctype.startswith("text/event-stream"):
        fail(f"SSE answer {sse_status} with Content-Type {sse_ctype}")
    if streamed != inproc["stream_tokens"]:
        fail(f"SSE tokens {streamed} != in-process {inproc['stream_tokens']}")
    if launches != config.n_layer * forwards:
        fail(f"splash launches over HTTP {launches} != n_layer * forwards = "
             f"{config.n_layer} * {forwards}")
    others = {k: n for k, n in counts.items()
              if n and k != "splash_attention_fwd"}
    if others:
        fail(f"the HTTP serving path launched other kernels: {others}")
    med = statistics.median
    result = dict(
        unary_lengths=list(SERVE_LENGTHS), unary_answers=answers,
        unary_latency_ms=latencies,
        timed_rounds=HTTP_ROUNDS,
        unary_http_ms=[med(http_ms[n]) for n in SERVE_LENGTHS],
        unary_inproc_ms=[med(inproc_ms[n]) for n in SERVE_LENGTHS],
        unary_overhead_ms=[med(http_ms[n]) - med(inproc_ms[n])
                           for n in SERVE_LENGTHS],
        stream_prompt_len=len(prompt), stream_tokens=streamed,
        stream_gap_ms=_gaps_ms(t_sse, arrivals),
        decode_tokens_per_s_http=med(rates["http"]),
        decode_tokens_per_s_inproc=med(rates["inproc"]),
        gap_ms_median_http=med(g for run in gap_runs["http"] for g in run[1:]),
        gap_ms_median_inproc=med(g for run in gap_runs["inproc"]
                                 for g in run[1:]),
        sse_content_type=sse_ctype, forwards=forwards,
        splash_launches=launches, launches=counts,
        deploy_next_s=deploy_next_s, delete_and_deploy_stream_s=redeploy_s)
    print("serve_http " + json.dumps(result), flush=True)
    return result


# serve_batch: 64 unary requests of lengths uniform in [1, 1024] from a numpy
# seed, sent by 1, 8 and 32 concurrent HTTP clients, batched and unbatched
# in turns, BATCH_ROUNDS times; 8 SSE streams of their own 64-token prompts,
# 16 tokens each, half of them admitted once the first tokens have arrived;
# MUX_REQUESTS multiplexed requests alternating two seeds, then a third.
BATCH_REQUESTS = 64
BATCH_CLIENTS = (1, 8, 32)
BATCH_ROUNDS = 2
CONT_STREAMS = 8
MUX_REQUESTS = 16


def _batch_inputs():
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 1025, BATCH_REQUESTS)
    requests = [rng.integers(0, 50257, n).tolist() for n in lengths]
    prompts = [rng.integers(0, 50257, SERVE_PROMPT_LEN).tolist()
               for _ in range(CONT_STREAMS)]
    return requests, prompts


def _post_concurrently(url: str, bodies: list, clients: int
                       ) -> Tuple[list, float]:
    """Every body POSTed by ``clients`` threads at once; the answers in the
    bodies' order and the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        outs = list(pool.map(lambda b: _post_json(url, b), bodies))
    return outs, time.perf_counter() - t0


def _handle_concurrently(handle, bodies: list, clients: int) -> float:
    """Every body sent through the deployment handle (no HTTP) by
    ``clients`` threads at once; the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(lambda b: handle.remote(_Request(body=b)).result(
            timeout_s=120), bodies))
    return time.perf_counter() - t0


def _streams_concurrently(url: str, queries: list, late_after: int
                          ) -> Tuple[list, float]:
    """One SSE GET per query on its own thread. The first ``late_after``
    start at once; the others once each of those has its first token (all
    at once when ``late_after`` covers every query). Returns per stream
    (status, events, arrivals) and the start time."""
    import threading

    results = [None] * len(queries)
    first = [threading.Event() for _ in queries]

    def run(i):
        import urllib.request

        req = urllib.request.Request(f"{url}?{queries[i]}",
                                     headers={"Accept": "text/event-stream"})
        events, arrivals = [], []
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                for raw in resp:
                    if raw.startswith(b"data: "):
                        arrivals.append(time.perf_counter())
                        events.append(json.loads(raw[len(b"data: "):]))
                        first[i].set()
                results[i] = (resp.status, events, arrivals)
        finally:
            first[i].set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(queries))]
    for t in threads[:late_after]:
        t.start()
    for e in first[:late_after]:
        e.wait(120)
    for t in threads[late_after:]:
        t.start()
    for t in threads:
        t.join(300)
    return results, t0


def _stream_stats(results: list, t0: float) -> Dict[str, object]:
    tokens = sum(len(events) for _, events, _ in results)
    last = max(arrivals[-1] for _, _, arrivals in results)
    gaps = [b - a for _, _, arr in results for a, b in zip(arr, arr[1:])]
    gaps_ms = sorted(g * 1e3 for g in gaps)
    return dict(tokens_per_s=tokens / (last - t0),
                gap_ms_p50=statistics.median(gaps_ms),
                gap_ms_p99=gaps_ms[min(len(gaps_ms) - 1,
                                       int(0.99 * len(gaps_ms)))],
                ttft_ms=[(arr[0] - t0) * 1e3 for _, _, arr in results])


def phase_serve_batch(params) -> Dict[str, object]:
    """The batched serving paths through ``serve.run`` and HTTP, at GPT-2
    124M with the serving phases' weights, each replica on half the card
    (``num_gpus=0.5``) so that two live at once; the replicas are threads of
    this process, so the splash launch counters are the ones every phase
    reads.

    (a) ``GPT2BatchNext`` (``@serve.batch``, up to 32 per forward) and
    ``GPT2Next`` answer the same 64 requests from 1, 8 and 32 concurrent
    clients, in turns. Every answer keeps the tie rule against the
    in-process ``GPT2Next`` logits for its tokens; the splash launches of a
    batched run are ``n_layer`` per vectorized call, of an unbatched one
    ``n_layer`` per request; at 32 clients a batch larger than 1 forms. The
    64 requests' logits from in-process batched forwards (two of 32) are
    held to the same logits, as ``phase_serve`` holds its answers.
    (b) ``GPT2ContinuousStream`` (``@serve.continuous_batch``) streams 8 SSE
    answers, 4 admitted while the first 4 are in flight, beside 8
    concurrent streams of ``GPT2Stream``; every token keeps the tie rule
    against the plain-attention model at its stream's prefix, launches are
    ``n_layer`` per step (per token for ``GPT2Stream``), and steps are
    shared (fewer than 8 x 16) with more than 4 streams in some step.
    (c) ``GPT2MultiplexNext`` on two replicas, one model each: 16 requests
    alternate seeds 1 and 2 (the first two at once, so the models land on
    different replicas), then one asks for seed 3. Answers keep the tie
    rule against ``GPT2Next`` built from the seed; once the router knows
    where each model lives, the second half of the traffic loads nothing;
    after the seed-3 eviction the card holds no more than half a weight set
    above the level before it."""
    import gc

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import batching, multiplex
    from ray_tpu_torch.serve import metrics as serve_metrics

    config = gpt2.GPTConfig()
    ref_config = dataclasses.replace(config, attn_impl="xla")
    n_layer = config.n_layer
    requests, prompts = _batch_inputs()
    half = {"num_gpus": 0.5}
    local_next = serve.GPT2Next(config, params=params)
    weights = dict(local_next.params)
    weights.update(weights.pop("blocks"))
    weight_bytes = sum(t.numel() * t.element_size() for t in weights.values())
    worst = 0.0
    result: Dict[str, object] = dict(weight_set_bytes=weight_bytes)
    totals: Dict[str, int] = {}

    def take() -> int:
        """Reads the launch counts of the window that just ended (reset
        just before it) into the phase's totals; the splash launches."""
        counts = _counts()
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        return counts["splash_attention_fwd"]

    def gap(ref, chosen):
        return (ref.max() - ref[chosen]).item()

    def ref_rows(arr, positions):
        """Plain-attention logits at ``positions`` of the (B, S) tokens."""
        dev = local_next.device
        with torch.inference_mode():
            t = torch.as_tensor(arr, device=dev)
            x = gpt2.forward_hidden(local_next.params, t, ref_config)
            x = x[torch.arange(len(positions), device=dev),
                  torch.as_tensor(positions, device=dev)]
            return gpt2.lm_head(x, local_next.params["wte"], torch.float32)

    with torch.inference_mode():
        ref_logits = torch.stack([local_next.logits(t) for t in requests])
    ref_answers = torch.argmax(ref_logits, dim=-1).tolist()

    # (a)'s in-process check: the 64 requests as two batched forwards.
    local_batch = serve.GPT2BatchNext(config, params=params)
    batched = []
    for i in range(0, BATCH_REQUESTS, 32):
        chunk = requests[i:i + 32]
        arr = np.zeros((len(chunk), max(map(len, chunk))), np.int64)
        for row, toks in enumerate(chunk):
            arr[row, :len(toks)] = toks
        batched.append(local_batch.logits_rows(arr, [len(t) - 1 for t in chunk]))
    batched = torch.cat(batched)
    if batched.shape != ref_logits.shape or not torch.isfinite(batched).all():
        fail(f"batched logits of shape {tuple(batched.shape)} or non-finite")
    dlogit = (batched - ref_logits).abs().max().item()
    batched_answers = torch.argmax(batched, dim=-1).tolist()
    worst_gap = max(gap(ref_logits[i], a) for i, a in enumerate(batched_answers))
    if dlogit > LOGIT_ATOL or worst_gap > LOGIT_ATOL:
        fail(f"in-process batched logits: max|dlogit| {dlogit}, a chosen "
             f"token {worst_gap} below the B=1 maximum (tol {LOGIT_ATOL})")
    # One vectorized call's host time at S=1024, by batch size.
    forward_ms = {}
    for B in (1, 8, 32):
        arr = np.zeros((B, config.seq_len), np.int64)
        forward_ms[B] = time_ms(lambda: local_batch.logits_rows(
            arr, [config.seq_len - 1] * B), iters=5)
    del local_batch, batched
    result["inproc_batched_max_abs_logit_err"] = dlogit

    ray_tpu_torch.init()
    try:
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address

        # ------------------------------------------ (a) batched unary
        h_batch = serve.run(
            serve.deployment(max_ongoing_requests=64, ray_actor_options=half)(
                serve.GPT2BatchNext).bind(config, params=params),
            name="gpt2batch", route_prefix="/gpt2batch")
        h_next = serve.run(
            serve.deployment(max_ongoing_requests=64, ray_actor_options=half)(
                serve.GPT2Next).bind(config, params=params),
            name="gpt2", route_prefix="/gpt2")
        bodies = [{"tokens": t} for t in requests]
        # Warm-up, not counted: the replicas' threads, a full batch.
        _post_concurrently(f"{addr}/gpt2", bodies[:2], 2)
        _post_concurrently(f"{addr}/gpt2batch", bodies[:32], 32)

        runs = {"batched": {c: [] for c in BATCH_CLIENTS},
                "unbatched": {c: [] for c in BATCH_CLIENTS}}
        batch_tags = {"deployment": "GPT2BatchNext", "method": "next_token"}
        sizes_by_clients = {c: [] for c in BATCH_CLIENTS}
        differ = {"batched": 0, "unbatched": 0}
        batched_launches = vectorized = unbatched_launches = 0
        for clients in BATCH_CLIENTS:
            for _ in range(BATCH_ROUNDS):
                for kind, route in (("batched", "gpt2batch"),
                                    ("unbatched", "gpt2")):
                    seen = batching.BATCH_SIZE_HISTOGRAM.get(tags=batch_tags)
                    _reset_counts()
                    outs, secs = _post_concurrently(f"{addr}/{route}", bodies,
                                                    clients)
                    launches = take()
                    runs[kind][clients].append(BATCH_REQUESTS / secs)
                    for i, (status, _, out) in enumerate(outs):
                        ans = out.get("next_token")
                        if status != 200 or not isinstance(ans, int):
                            fail(f"{kind} answer {status} {out}")
                        g = gap(ref_logits[i], ans)
                        worst = max(worst, g)
                        if g > LOGIT_ATOL:
                            fail(f"{kind} answer {ans} at {clients} clients "
                                 f"for request {i} (length "
                                 f"{len(requests[i])}) is {g} below the "
                                 f"in-process maximum (tol {LOGIT_ATOL})")
                        differ[kind] += ans != ref_answers[i]
                    if kind == "unbatched":
                        unbatched_launches += launches
                        if launches != n_layer * BATCH_REQUESTS:
                            fail(f"unbatched splash launches {launches} != "
                                 f"{n_layer} * {BATCH_REQUESTS}")
                        continue
                    # serve_batch_size over this run: one observation per
                    # vectorized call, its value the call's batch size.
                    sizes = _since(batching.BATCH_SIZE_HISTOGRAM, batch_tags,
                                   seen)
                    sizes_by_clients[clients].append(sizes)
                    batched_launches += launches
                    vectorized += sizes["count"]
                    if sizes["sum"] != BATCH_REQUESTS:
                        fail(f"batches {sizes} hold {sizes['sum']} "
                             f"requests, sent {BATCH_REQUESTS}")
                    if launches != n_layer * sizes["count"]:
                        fail(f"batched splash launches {launches} != "
                             f"n_layer * vectorized calls = {n_layer} * "
                             f"{sizes['count']}")
        if all(s["sum"] <= s["count"] for s in sizes_by_clients[32]):
            fail(f"no batch larger than 1 formed at 32 clients: "
                 f"{sizes_by_clients[32]}")
        # Where the batched qps stops: the same traffic at 32 clients
        # through the handle, without the proxy and the HTTP clients.
        handle_qps = {}
        for kind, h in (("batched", h_batch), ("unbatched", h_next)):
            _reset_counts()
            handle_qps[kind] = BATCH_REQUESTS / _handle_concurrently(
                h, bodies, 32)
            take()
        med = statistics.median
        result["unary"] = dict(
            requests=BATCH_REQUESTS, rounds=BATCH_ROUNDS,
            qps={kind: {f"c{c}": med(v) for c, v in by.items()}
                 for kind, by in runs.items()},
            qps_runs={kind: {f"c{c}": v for c, v in by.items()}
                      for kind, by in runs.items()},
            speedup={f"c{c}": med(runs["batched"][c])
                     / med(runs["unbatched"][c]) for c in BATCH_CLIENTS},
            batch_sizes={f"c{c}": v for c, v in sizes_by_clients.items()},
            handle_qps_c32=handle_qps,
            forward_ms_by_batch=forward_ms,
            vectorized_calls=vectorized, splash_launches=batched_launches,
            unbatched_splash_launches=unbatched_launches,
            answers_differing_exactly=differ,
            worst_gap_below_max=worst)
        serve.delete("gpt2batch")
        serve.delete("gpt2")

        # --------------------------------------- (b) continuous batching
        deploy = serve.deployment(max_ongoing_requests=64,
                                  ray_actor_options=half)
        serve.run(deploy(serve.GPT2ContinuousStream).bind(config, params=params),
                  name="gpt2cont", route_prefix="/gpt2cont")
        serve.run(deploy(serve.GPT2Stream).bind(config, params=params),
                  name="gpt2stream", route_prefix="/gpt2stream")
        for route in ("gpt2cont", "gpt2stream"):  # warm-up
            _sse(f"{addr}/{route}?tokens=1,2,3&max_new=2")
        queries = [f"tokens={','.join(map(str, p))}&max_new={SERVE_MAX_NEW}"
                   for p in prompts]
        # The engine observes serve_execution_seconds once per step. Only
        # streams reach this deployment, and a stream's request adds no
        # observation of its own under these tags.
        step_tags = {"deployment": "GPT2ContinuousStream",
                     "method": "__call__"}
        seen = serve_metrics.EXECUTION.get(tags=step_tags)
        _reset_counts()
        cont, t_cont = _streams_concurrently(f"{addr}/gpt2cont", queries,
                                             CONT_STREAMS // 2)
        cont_launches = take()
        steps = _since(serve_metrics.EXECUTION, step_tags, seen)["count"]
        _reset_counts()
        per_req, t_per = _streams_concurrently(f"{addr}/gpt2stream", queries,
                                               CONT_STREAMS)
        per_req_launches = take()
        serve.delete("gpt2cont")
        serve.delete("gpt2stream")
        for label, runs_ in (("continuous", cont), ("per-request", per_req)):
            for status, events, _ in runs_:
                if status != 200 or len(events) != SERVE_MAX_NEW:
                    fail(f"{label} stream {status} gave {len(events)} tokens")
        total = CONT_STREAMS * SERVE_MAX_NEW
        if cont_launches != n_layer * steps:
            fail(f"continuous splash launches {cont_launches} != n_layer * "
                 f"steps = {n_layer} * {steps}")
        if steps >= total:
            fail(f"{steps} continuous steps for {total} tokens shared "
                 f"nothing")
        # Each step emits one token per stream it holds: with at most
        # CONT_STREAMS // 2 per step, the tokens would need this many steps.
        if steps >= total // (CONT_STREAMS // 2):
            fail(f"{steps} continuous steps for {total} tokens: no step held "
                 f"a stream admitted mid-flight")
        if per_req_launches != n_layer * total:
            fail(f"per-request stream launches {per_req_launches} != "
                 f"{n_layer} * {total}")
        # Every token against the plain-attention model at its prefix.
        S = config.seq_len
        cont_gap = 0.0
        for label, runs_ in (("continuous", cont), ("per-request", per_req)):
            seqs = [list(p) for p in prompts]
            for step in range(SERVE_MAX_NEW):
                arr = np.zeros((CONT_STREAMS, S), np.int64)
                for row, seq in enumerate(seqs):
                    arr[row, :len(seq)] = seq
                ref = ref_rows(arr, [len(seq) - 1 for seq in seqs])
                for row, (_, events, _) in enumerate(runs_):
                    tok = events[step].get("token")
                    g = gap(ref[row], tok)
                    cont_gap = max(cont_gap, g)
                    if g > LOGIT_ATOL:
                        fail(f"{label} stream {row} step {step}: token {tok} "
                             f"is {g} below the plain model's maximum "
                             f"(tol {LOGIT_ATOL})")
                    seqs[row].append(tok)
        c_stats = _stream_stats(cont, t_cont)
        p_stats = _stream_stats(per_req, t_per)
        result["continuous"] = dict(
            streams=CONT_STREAMS, max_new=SERVE_MAX_NEW,
            prompt_len=SERVE_PROMPT_LEN, steps=steps,
            splash_launches=cont_launches,
            per_request_splash_launches=per_req_launches,
            continuous=c_stats, per_request=p_stats,
            tokens_per_s_ratio=c_stats["tokens_per_s"]
            / p_stats["tokens_per_s"],
            worst_gap_below_max=cont_gap)

        # ---------------------------------------------- (c) multiplexing
        def loads():
            return sum(v for _, _, v in multiplex.MODEL_LOADS.samples())

        def evictions():
            return sum(v for _, _, v in multiplex.MODEL_EVICTIONS.samples())

        h_mux = serve.run(
            serve.deployment(num_replicas=2, max_ongoing_requests=64,
                             ray_actor_options=half)(serve.GPT2MultiplexNext)
            .bind(config, max_num_models_per_replica=1),
            name="gpt2mux", route_prefix=None)
        hs = {s: h_mux.options(multiplexed_model_id=f"seed-{s}")
              for s in (1, 2, 3)}
        mux_reqs = requests[:MUX_REQUESTS + 1]
        seeds = [1 + i % 2 for i in range(MUX_REQUESTS)] + [3]
        loads0 = loads()
        _reset_counts()
        # The first two at once: the second sees the first in flight on
        # one replica and goes to the other.
        pair = [hs[s].remote({"tokens": t})
                for s, t in zip(seeds[:2], mux_reqs[:2])]
        mux_answers = [r.result(timeout_s=300)["next_token"] for r in pair]
        sched = h_mux._get_router()._scheduler
        deadline = time.time() + 30
        while True:
            with sched._lock:
                view = sorted(tuple(r.get("multiplexed_model_ids") or ())
                              for r in sched._replicas)
            if view == [("seed-1",), ("seed-2",)]:
                break
            if time.time() > deadline:
                fail(f"the router's view of the replicas' models: {view}")
            time.sleep(0.05)
        def ask(i):
            mux_answers.append(hs[seeds[i]].remote(
                {"tokens": mux_reqs[i]}).result(timeout_s=300)["next_token"])

        for i in range(2, MUX_REQUESTS // 2):
            ask(i)
        loads_first_half = loads()
        for i in range(MUX_REQUESTS // 2, MUX_REQUESTS):
            ask(i)
        loads_second_half = loads() - loads_first_half
        if loads_second_half:
            fail(f"{loads_second_half} loads in the second half of the "
                 f"alternating traffic: warm routing did not hold")
        torch.cuda.synchronize()
        gc.collect()
        mem_before = torch.cuda.memory_allocated()
        evict0 = evictions()
        ask(MUX_REQUESTS)
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        mux_launches = take()
        if evictions() - evict0 != 1:
            fail(f"seed-3 evicted {evictions() - evict0} models, wanted 1")
        if mem_after > mem_before + weight_bytes // 2:
            fail(f"after the eviction the card holds {mem_after} bytes, "
                 f"{mem_after - mem_before} more than before it (one weight "
                 f"set is {weight_bytes}): the evicted weights stayed")
        mux_loads = loads() - loads0
        serve.delete("gpt2mux")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    mux_gap = 0.0
    mux_differ = 0
    for seed in (1, 2, 3):
        model = serve.GPT2Next(config, seed=seed)
        with torch.inference_mode():
            for toks, s, ans in zip(mux_reqs, seeds, mux_answers):
                if s != seed:
                    continue
                logits = model.logits(toks)
                g = gap(logits, ans)
                mux_gap = max(mux_gap, g)
                mux_differ += ans != int(torch.argmax(logits))
                if g > LOGIT_ATOL:
                    fail(f"multiplexed answer {ans} for seed-{seed} is {g} "
                         f"below GPT2Next's maximum (tol {LOGIT_ATOL})")
        del model
    result["multiplex"] = dict(
        requests=len(mux_answers), seeds=seeds, loads=mux_loads,
        loads_second_half=loads_second_half, evictions=evictions() - evict0,
        memory_before_seed3=mem_before, memory_after_seed3=mem_after,
        splash_launches=mux_launches, answers_differing_exactly=mux_differ,
        worst_gap_below_max=mux_gap)
    others = {k: n for k, n in totals.items()
              if n and k != "splash_attention_fwd"}
    if others:
        fail(f"the batched serving paths launched other kernels: {others}")
    result["splash_launches"] = totals["splash_attention_fwd"]
    result["launches"] = totals
    print("serve_batch " + json.dumps(result), flush=True)
    return result


def _since(hist, tags: dict, before: dict) -> Dict[str, object]:
    """A histogram's observations since the snapshot ``before``: their
    number, their sum, and their number in each bucket by upper bound."""
    now = hist.get(tags=tags)
    labels = [str(b) for b in now["boundaries"]] + ["inf"]
    return {"count": now["count"] - before["count"],
            "sum": now["sum"] - before["sum"],
            "by_bucket": {le: a - b for le, a, b in zip(
                labels, now["counts"], before["counts"]) if a - b}}


def _gaps_ms(t0: float, arrivals: list) -> list:
    """Gaps between a request's start and each token's arrival, in ms: the
    first is the time to the first token."""
    return [(b - a) * 1e3 for a, b in zip([t0] + arrivals, arrivals)]


def phase_ring(peaks: Tuple[float, float]) -> Dict[str, object]:
    import torch

    from ray_tpu_torch.ops import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(3)
    W = RING_WORLD
    rows, main = [], None
    worst = {"fwd": 0.0, "bwd_abs": 0.0, "bwd_rel": 0.0}
    for n, (B, shard, H, hd, causal) in enumerate(RING_SHAPES):
        q, k, v = _qkv(gen, B, W * shard, H, hd)
        do = torch.randn(q.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        o, lse = ra.ring_forward(q, k, v, world=W, causal=causal)
        grads = ra.ring_backward(q, k, v, o, lse, do, world=W, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = ra.ring_forward(q, k, v, world=W, causal=causal,
                                         plain=True)
        refs = ra.ring_backward(q, k, v, o, lse, do, world=W, causal=causal,
                                plain=True)
        shape = dict(B=B, S_local=shard, H=H, hd=hd, W=W, causal=causal)
        if not all(torch.isfinite(x).all() for x in (o, lse, *grads)):
            fail(f"non-finite ring kernel output at {shape}")
        row = dict(shape, o_max_abs_err=(o - o_ref).abs().max().item(),
                   lse_max_abs_err=(lse - lse_ref).abs().max().item())
        if row["o_max_abs_err"] > O_ATOL or row["lse_max_abs_err"] > LSE_ATOL:
            fail(f"ring_attention_fwd disagrees with its plain version at "
                 f"{shape}: {row} (tol {O_ATOL}, {LSE_ATOL})")
        worst["fwd"] = max(worst["fwd"], row["o_max_abs_err"])
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            row[f"{name}_rel_err"] = rel_err(g, r)
            row[f"{name}_abs_err"] = (g - r).abs().max().item()
            worst["bwd_abs"] = max(worst["bwd_abs"], row[f"{name}_abs_err"])
            worst["bwd_rel"] = max(worst["bwd_rel"], row[f"{name}_rel_err"])
            if row[f"{name}_rel_err"] > BWD_RTOL:
                fail(f"ring_attention_bwd {name} disagrees with its plain "
                     f"version at {shape}: {row[f'{name}_rel_err']} "
                     f"(tol {BWD_RTOL})")
        if n == 0:  # the training path's shape: time it
            row.update(_ring_times(peaks, q, k, v, do, o, lse, causal))
            main = row
        rows.append(row)
        print("kernel ring_attention " + json.dumps(row), flush=True)
        del q, k, v, do, o, lse, grads, o_ref, lse_ref, refs
    torch.cuda.empty_cache()
    whole = _ring_against_splash(gen)
    torch.cuda.empty_cache()
    return dict(rows=rows, main=main, worst=worst, whole=whole)


def _ring_times(peaks, q, k, v, do, o, lse, causal) -> Dict[str, object]:
    """Device ms of each ring kernel per launch (steps 0 and 1) and over the
    W launches of one layer's attention, beside the plain versions and the
    bounds (``bound_ms`` with the first step's blocks write-only,
    ``bound_ms_accumulate`` with every block reading its accumulators);
    host ms per launch. The accumulators are scratch tensors that the timed
    launches keep merging into. They hold NaN when step 0 is timed: step 0
    reads none of them, so they must come out finite."""
    import torch

    from ray_tpu_torch.ops import ring_attention as ra

    W = RING_WORLD
    B, S, H, hd = q.shape
    shard = S // W
    o_t, lse_t = o.clone(), lse.clone()
    delta = ra.ring_delta(o, do)
    acc = [torch.empty_like(o) for _ in range(3)]
    fwd_args = (q, k, v, o_t, lse_t)
    bwd_args = (q, k, v, do, lse, delta, *acc)

    def steps(fn, args, which):
        return lambda: [fn(*args, step=s, world=W, causal=causal)
                        for s in which]

    def bounds(which, n_diag, n_full, n_first):
        bound_ms, bound_by = ring_bound(which, B, shard, H, hd, n_diag,
                                        n_full, *peaks, n_first=n_first)
        return dict(bound_ms=bound_ms, bound_by=bound_by,
                    bound_ms_accumulate=ring_bound(
                        which, B, shard, H, hd, n_diag, n_full, *peaks)[0])

    out = {"per_launch": []}
    for s in (0, 1):
        n = len(ra.ring_pairs(s, W, causal))
        blocks = (n, 0) if causal and s == 0 else (0, n)
        launch = dict(step=s, pairs=n)
        if s == 0:
            for x in (o_t, lse_t, *acc):
                x.fill_(float("nan"))
        for which, kern, plain, args, accs in (
                ("fwd", ra.ring_fwd_step, ra.ring_fwd_step_plain, fwd_args,
                 (o_t, lse_t)),
                ("bwd", ra.ring_bwd_step, ra.ring_bwd_step_plain, bwd_args,
                 acc)):
            launch[f"{which}_ms"] = device_ms(steps(kern, args, [s]))
            if s == 0 and not all(torch.isfinite(x).all() for x in accs):
                fail(f"ring step 0 ({which}) left a NaN of its accumulators: "
                     "it read them")
            launch.update({
                f"{which}_plain_ms": device_ms(steps(plain, args, [s]),
                                               iters=2),
                **{f"{which}_{key}": val for key, val in bounds(
                    which, *blocks, n if s == 0 else 0).items()},
                f"{which}_call_ms": time_ms(steps(kern, args, [s]))})
        out["per_launch"].append(launch)
    causal_blocks = (W, W * (W - 1) // 2) if causal else (0, W * W)
    for which, kern, plain, args in (
            ("fwd", ra.ring_fwd_step, ra.ring_fwd_step_plain, fwd_args),
            ("bwd", ra.ring_bwd_step, ra.ring_bwd_step_plain, bwd_args)):
        out[which] = dict(
            launches=W, ms=device_ms(steps(kern, args, range(W))),
            plain_ms=device_ms(steps(plain, args, range(W)), iters=2),
            **bounds(which, *causal_blocks, W),
            call_ms=time_ms(steps(kern, args, range(W))))
    return out


# What a kernel holds on an SM, as the sources' ``*_resources`` entries
# give it (kernel_resources in csrc/mma_sm90.cuh).
RESOURCE_FIELDS = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
                   "blocks_per_sm")


def ce_resources() -> Dict[str, object]:
    """What the fused CE kernels hold on an SM, by width: the forward's
    from ``fused_ce_fwd_resources`` (with its cluster size and the clusters
    the card holds at once), dx's and dW's from ``fused_ce_resources``."""
    import ctypes

    from ray_tpu_torch._private import kernel_build

    lib = kernel_build.load("fused_ce")
    for fn in (lib.fused_ce_fwd_resources, lib.fused_ce_resources):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = {}
    for D in (64, 128, 768):
        buf = (ctypes.c_int * 7)()
        err = lib.fused_ce_fwd_resources(D, ctypes.addressof(buf))
        if err != 0:
            fail(f"fused_ce_fwd_resources({D}): CUDA error {err}")
        out[f"fwd D={D}"] = dict(zip(
            RESOURCE_FIELDS + ("cluster_size", "active_clusters"), buf))
    for D in (64, 128, 768):
        buf = (ctypes.c_int * 10)()
        err = lib.fused_ce_resources(D, ctypes.addressof(buf))
        if err != 0:
            fail(f"fused_ce_resources({D}): CUDA error {err}")
        for i, kernel in enumerate(("dx", "dw")):
            out[f"{kernel} D={D}"] = dict(
                zip(RESOURCE_FIELDS, buf[5 * i:5 * i + 5]))
    return out


def ring_resources() -> Dict[str, object]:
    """What each ring kernel holds on an SM (registers, spill bytes, static
    and dynamic shared bytes, resident blocks per SM), by head_dim and step
    kind, from the ring sources' ``*_resources`` entries."""
    import ctypes

    from ray_tpu_torch._private import kernel_build

    out = {}
    for name, kernels in (("ring_attention_fwd", ("fwd",)),
                          ("ring_attention_bwd", ("dkv", "dq"))):
        fn = getattr(kernel_build.load(name), f"{name}_resources")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for hd in (64, 128):
            for first in (0, 1):
                buf = (ctypes.c_int * (5 * len(kernels)))()
                err = fn(hd, first, ctypes.addressof(buf))
                if err != 0:
                    fail(f"{name}_resources({hd}, {first}): CUDA error {err}")
                for i, kernel in enumerate(kernels):
                    out[f"{kernel} hd={hd} {'first' if first else 'later'}"] = \
                        dict(zip(RESOURCE_FIELDS, buf[5 * i:5 * i + 5]))
    return out


def splash_resources() -> Dict[str, object]:
    """What each splash kernel holds on an SM (the forward; the backward's
    dk/dv and dq kernels), by head_dim, from the sources' ``*_resources``
    entries."""
    import ctypes

    from ray_tpu_torch._private import kernel_build

    out = {}
    for name, kernels in (("splash_attention_fwd", ("fwd",)),
                          ("splash_attention_bwd", ("dkv", "dq"))):
        fn = getattr(kernel_build.load(name), f"{name}_resources")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for hd in (64, 128):
            buf = (ctypes.c_int * (5 * len(kernels)))()
            err = fn(hd, ctypes.addressof(buf))
            if err != 0:
                fail(f"{name}_resources({hd}): CUDA error {err}")
            for i, kernel in enumerate(kernels):
                out[f"{kernel} hd={hd}"] = dict(
                    zip(RESOURCE_FIELDS, buf[5 * i:5 * i + 5]))
    return out


def _ring_against_splash(gen) -> Dict[str, object]:
    """Whole ring attention (W=4, FusedRing, the kernels) against the splash
    kernels on the same q, k, v, forward and gradient, with the device time
    of each and of SDPA, forward by CUDA-graph replay and backward by events
    around back-to-back calls (an autograd backward does not capture)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.parallel import MeshSpec

    B, S, H, hd = RING_WHOLE_SHAPE
    mesh = MeshSpec(seq=RING_WORLD)
    qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    out_r = ra.ring_attention(q, k, v, mesh=mesh)
    if type(out_r.grad_fn).__name__ != "FusedRingBackward":
        fail(f"ring_attention's gradient is {type(out_r.grad_fn).__name__}")
    out_s = attention.splash_attention(q, k, v)
    (g_r,) = torch.autograd.grad(out_r, qkv, do, retain_graph=True)
    (g_s,) = torch.autograd.grad(out_s, qkv, do, retain_graph=True)
    res = dict(B=B, S=S, H=H, hd=hd, W=RING_WORLD,
               o_max_abs_err=(out_r.float() - out_s.float()).abs().max().item())
    for name, a, b in zip(("dq", "dk", "dv"), g_r.split(H * hd, -1),
                          g_s.split(H * hd, -1)):
        res[f"{name}_rel_err"] = rel_err(a, b)
    print("ring_vs_splash " + json.dumps(res), flush=True)
    if res["o_max_abs_err"] > O_ATOL:
        fail(f"ring_attention differs from splash_attention: {res}")
    if max(res[f"{n}_rel_err"] for n in ("dq", "dk", "dv")) > BWD_RTOL:
        fail(f"ring_attention's gradient differs from splash's: {res}")

    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out_l = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        res["fwd_ms"] = dict(
            ring=device_ms(lambda: ra.ring_attention(q, k, v, mesh=mesh)),
            splash=device_ms(lambda: attention.splash_attention(q, k, v)),
            sdpa=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)))
    res["bwd_ms"] = dict(
        ring=loop_ms(lambda: torch.autograd.grad(out_r, qkv, do,
                                                 retain_graph=True)),
        splash=loop_ms(lambda: torch.autograd.grad(out_s, qkv, do,
                                                   retain_graph=True)),
        sdpa=loop_ms(lambda: torch.autograd.grad(out_l, (qt, kt, vt), dot,
                                                 retain_graph=True)))
    print("ring_whole_ms " + json.dumps(res), flush=True)
    return res


def _counts() -> Dict[str, int]:
    from ray_tpu_torch.ops import attention, fused_ce, ring_attention

    return {**attention.LAUNCHES, **fused_ce.LAUNCHES,
            **ring_attention.LAUNCHES}


def _reset_counts() -> None:
    from ray_tpu_torch.ops import attention, fused_ce, ring_attention

    for mod in (attention, fused_ce, ring_attention):
        mod.reset_launches()


def _train_start(config):
    """The training runs' common start: GPT-2 weights from seed 0 and one
    batch of B=16 tokens from a numpy seed."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2

    init = gpt2.init_params(config, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(0, 50257, (TRAIN_BATCH, config.seq_len + 1)),
        dtype=torch.long, device="cuda")
    return init, toks[:, :-1], toks[:, 1:]


def _train_steps(label, config, step, params, opt_state, tokens, targets,
                 want, peaks, card) -> Dict[str, object]:
    """TRAIN_STEPS steps of ``step``, checking each step's launch counts
    against ``want`` (every kernel not named there: 0) and that the losses
    are finite and fall. Counts are set to 0 just before and read after."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        before = _counts()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        delta = {k: v - before[k] for k, v in _counts().items()}
        expected = {k: want.get(k, 0) for k in delta}
        if delta != expected:
            fail(f"{label} step {i}: launches {delta}, expected {expected}")
    launches = _counts()
    if not all(np.isfinite(losses)):
        fail(f"{label} training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label} training loss did not fall: {losses}")
    # Steps after the first (which sets up cuBLAS and the allocator).
    steps_per_s = (TRAIN_STEPS - 1) / sum(step_s[1:])
    tokens_per_s = steps_per_s * TRAIN_BATCH * config.seq_len
    mfu = 100.0 * gpt2.flops_per_token(config) * tokens_per_s / peaks[1]
    return dict(losses=losses, step_s=step_s, steps_per_s=steps_per_s,
                tokens_per_s=tokens_per_s, mfu_pct=mfu, launches=launches,
                card=card,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _check_step_against(label, cfg, ref_cfg, init, small, mesh=None
                        ) -> Dict[str, object]:
    """One B=2 loss and gradient of ``cfg`` against ``ref_cfg`` on the same
    weights: loss within LOSS_ATOL, every leaf within GRAD_RTOL of its
    largest entry."""
    import contextlib

    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map
    from ray_tpu_torch.parallel import use_mesh

    def loss_and_grads(c):
        params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                          init)
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            loss = gpt2.loss_fn(params, *small, c)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        return float(loss.detach()), grads

    loss, grads = loss_and_grads(cfg)
    ref_loss, ref_grads = loss_and_grads(ref_cfg)
    errs = {n: rel_err(g, r)
            for n, g, r in zip(_leaf_names(init), grads, ref_grads)}
    worst = max(errs, key=errs.get)
    check = dict(loss=loss, ref_loss=ref_loss, loss_abs_err=abs(loss - ref_loss),
                 grad_rel_err=errs, worst_leaf=worst)
    print(f"train_check {label} " + json.dumps(check), flush=True)
    if not np.isfinite(loss) or abs(loss - ref_loss) > LOSS_ATOL:
        fail(f"B=2 {label} loss {loss} vs {ref_loss} (tol {LOSS_ATOL})")
    if errs[worst] > GRAD_RTOL:
        fail(f"B=2 {label} gradient {worst} off by {errs[worst]} of its "
             f"largest entry (tol {GRAD_RTOL})")
    return check


def phase_train_ring(peaks: Tuple[float, float], card: str
                     ) -> Dict[str, object]:
    """GPT-2 124M through attn_impl="ring" on a seq axis of W=4 folded onto
    the card: five steps from the splash run's start, then B=2 steps of the
    ring and of Ulysses against the splash path."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_map
    from ray_tpu_torch.parallel import MeshSpec, jit_train_step

    W = RING_WORLD
    config = gpt2.GPTConfig(attn_impl="ring", remat_policy="attn_outside",
                            scan_layers=False)
    mesh = MeshSpec(seq=W)
    init, tokens, targets = _train_start(config)
    params = tree_map(lambda p: p.detach().clone(), init)
    optimizer = gpt2.make_optimizer(3e-4)
    step = jit_train_step(gpt2.make_train_step(config, optimizer), mesh=mesh)
    want = {"ring_attention_fwd": config.n_layer * W,
            "ring_attention_bwd": config.n_layer * W}
    run = _train_steps("ring", config, step, params, optimizer.init(params),
                       tokens, targets, want, peaks, card)
    run.update(attn_impl="ring", seq_axis=W)
    print("train " + json.dumps(run), flush=True)
    del params, step
    torch.cuda.empty_cache()

    small = (tokens[:2], targets[:2])
    splash = gpt2.GPTConfig(remat_policy="attn_outside", scan_layers=False)
    checks = {label: _check_step_against(
        label, dataclasses.replace(config, attn_impl=label), splash, init,
        small, mesh) for label in ("ring", "ulysses")}
    torch.cuda.empty_cache()
    return dict(run=run, checks=checks)


def phase_train(peaks: Tuple[float, float], card: str) -> Dict[str, object]:
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import fused_ce
    from ray_tpu_torch.optim import tree_leaves, tree_map

    config = gpt2.GPTConfig(remat_policy="attn_outside", scan_layers=False)
    init, tokens, targets = _train_start(config)
    result: Dict[str, object] = {"launches": {}}

    def fresh():
        return tree_map(lambda p: p.detach().clone(), init)

    # (i) Five steps with each loss from the same start: the main path.
    for impl in ("dense", "fused"):
        cfg = dataclasses.replace(config, loss_impl=impl)
        params = fresh()
        optimizer = gpt2.make_optimizer(3e-4)
        step = gpt2.make_train_step(cfg, optimizer)
        want = {"splash_attention_fwd": config.n_layer,
                "splash_attention_bwd": config.n_layer,
                **{k: int(impl == "fused") for k in fused_ce.LAUNCHES}}
        run = _train_steps(impl, config, step, params, optimizer.init(params),
                           tokens, targets, want, peaks, card)
        run = dict(loss_impl=impl, **run)
        result[impl] = run
        result["launches"][impl] = run["launches"]
        print("train " + json.dumps(run), flush=True)
        del params, step
        torch.cuda.empty_cache()

    # (ii) One B=2 step of the kernel paths against plain attention, the
    # dense loss and full remat, on the same weights.
    small = (tokens[:2], targets[:2])

    def loss_and_grads(cfg):
        params = tree_map(lambda p: p.requires_grad_(True), fresh())
        loss = gpt2.loss_fn(params, *small, cfg)
        return (float(loss.detach()),
                torch.autograd.grad(loss, tree_leaves(params)))

    plain = dataclasses.replace(config, attn_impl="xla", loss_impl="dense",
                                remat_policy="full")
    result["checks"] = {
        "dense": _check_step_against("dense", config, plain, init, small),
        # The fused loss keeps fp32 logits: hold it to fp32 dense logits.
        "fused": _check_step_against(
            "fused", dataclasses.replace(config, loss_impl="fused"),
            dataclasses.replace(plain, logits_dtype=torch.float32), init,
            small)}

    # (iii) remat_policy="full" checkpoints each block whole, so the backward
    # reruns its splash forward: twice attn_outside's forward launches, the
    # same backward launches and the same gradients.
    _, split_grads = loss_and_grads(config)
    before = _counts()
    _, full_grads = loss_and_grads(
        dataclasses.replace(config, remat_policy="full"))
    delta = {k: v - before[k] for k, v in _counts().items()}
    full = dict(launches=delta,
                grads_equal=all(torch.equal(a, b)
                                for a, b in zip(full_grads, split_grads)),
                grad_rel_err=max(rel_err(a, b)
                                 for a, b in zip(full_grads, split_grads)))
    print("train_full_remat " + json.dumps(full), flush=True)
    if (delta["splash_attention_fwd"] != 2 * config.n_layer
            or delta["splash_attention_bwd"] != config.n_layer):
        fail(f"remat_policy='full' launched {delta}; expected "
             f"{2 * config.n_layer} splash forwards, {config.n_layer} "
             "backwards")
    # The kernels and the matmuls are deterministic: remat reruns the same
    # forward, so the gradients must be equal bit for bit.
    if not full["grads_equal"]:
        fail(f"remat_policy='full' changed the gradients: {full}")
    result["full_remat"] = full
    torch.cuda.empty_cache()
    return result


def _leaf_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch._private import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    kernel_build.build()
    print(f"build_seconds {time.perf_counter() - t0:.3f}", flush=True)
    for name in kernel_build.kernel_names():
        for line in kernel_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    resources = ring_resources()
    for kernel, res in resources.items():
        print(f"resources ring {kernel} " + json.dumps(res), flush=True)
    splash_res = splash_resources()
    for kernel, res in splash_res.items():
        print(f"resources splash {kernel} " + json.dumps(res), flush=True)
    ce_res = ce_resources()
    for kernel, res in ce_res.items():
        print(f"resources ce {kernel} " + json.dumps(res), flush=True)
    # The CE forward keeps a 64 x 256 fp32 logits tile in registers, the
    # backward a 64 x 384 fp32 accumulator, at D=768: a spill, or wgmma
    # serialised by ptxas, is a fault of the build.
    for kernel in ("fwd", "dx", "dw"):
        if ce_res[f"{kernel} D=768"]["spill_bytes"]:
            fail(f"fused CE {kernel} spills at D=768: "
                 f"{ce_res[f'{kernel} D=768']}")
    if "C751" in kernel_build.build_log("fused_ce"):
        fail("ptxas serialised the fused CE kernels' wgmma (a C751x note)")

    kern = phase_kernel(peaks)
    ce = phase_ce(peaks)
    ring = phase_ring(peaks)
    weights = serve_weights()
    serve = phase_serve(weights)
    train = phase_train(peaks, card)
    train_ring = phase_train_ring(peaks, card)
    # After every in-process phase, so that none of their numbers moves;
    # before the profiled ones, whose tracing slows small kernels.
    serve_http = phase_serve_http(weights, serve)
    serve_batch = phase_serve_batch(weights)
    del weights
    # Last: its yardstick runs under torch.profiler, whose tracing slowed
    # the serving forward's many small kernels when it ran before them.
    bwd = phase_attn_bwd(peaks)
    ce_dense = phase_ce_yardstick(ce)

    def entry(name, source, replaces, function, rows, by_path, worst, row,
              library_ms, shape, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    replaces_function=function, rows=rows,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=worst, ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_us=row["bound_ms"] * 1e3,
                    bound_by=row["bound_by"], library_ms=library_ms,
                    shape=shape, **extra)

    def paths(name):
        """Launches of kernel ``name`` on each main path, counted from 0
        just before the path ran."""
        out = {"serve": serve["launches"][name],
               "serve_http": serve_http["launches"][name],
               "serve_batch": serve_batch["launches"][name]}
        for impl in ("dense", "fused"):
            out[f"train_{impl}"] = train["launches"][impl][name]
        out["train_ring"] = train_ring["run"]["launches"][name]
        return out

    kernels = [
        entry("splash_attention_fwd",
              "ray_tpu_torch/csrc/splash_attention_fwd.cu",
              "ray_tpu/ops/attention.py:95",
              "ray_tpu.ops.attention.splash_attention (and flash_attention "
              ":128), forward", [1, 3], paths("splash_attention_fwd"),
              kern["worst"], kern["main"], kern["main"]["library_ms"],
              {k: kern["main"][k] for k in ("B", "S", "H", "hd", "causal")},
              train_shape_ms=kern["rows"][0]["ms"],
              serving_batch_shapes=[
                  {k: r[k] for k in ("B", "S", "H", "hd", "causal", "ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "plain_ms")}
                  for r in kern["rows"]
                  if (r["B"], r["S"], r["causal"]) in ((8, 1024, True),
                                                      (32, 1024, True),
                                                      (8, 517, True))],
              resources={k: r for k, r in splash_res.items()
                         if k.startswith("fwd")}),
        entry("splash_attention_bwd",
              "ray_tpu_torch/csrc/splash_attention_bwd.cu",
              "ray_tpu/ops/attention.py:56",
              "ray_tpu.ops.attention.splash_attention fused dq/dk/dv "
              "backward (and flash_attention's dkv and dq kernels)", [2, 4],
              paths("splash_attention_bwd"), bwd["worst_abs"], bwd["main"],
              bwd["main"]["library_ms"],
              {k: bwd["main"][k] for k in ("B", "S", "H", "hd", "causal")},
              max_rel_err=bwd["worst_rel"],
              library_ms_by=bwd["main"]["library_ms_by"],
              library_loop_ms=bwd["main"]["library_loop_ms"],
              profiled_ms=bwd["main"]["profiled_ms"],
              resources={k: r for k, r in splash_res.items()
                         if not k.startswith("fwd")}),
    ]
    for name, row_no, line, function in (
            ("fused_ce_fwd", 5, 81, "_fwd_pallas (_fwd_kernel :53)"),
            ("fused_ce_dx", 6, 154, "_bwd_pallas dx (_dx_kernel :113)"),
            ("fused_ce_dw", 7, 167, "_bwd_pallas dW (_dw_kernel :131)")):
        main_row = ce[name]["main"]
        kernels.append(entry(
            name, "ray_tpu_torch/csrc/fused_ce.cu",
            f"ray_tpu/ops/fused_ce.py:{line}",
            f"ray_tpu.ops.fused_ce.{function}", [row_no], paths(name),
            ce[name]["worst_abs"], main_row, None,
            {k: main_row[k] for k in ("N", "D", "V")},
            dense_ms=main_row["dense_ms"],
            resources={k: r for k, r in ce_res.items()
                       if k.startswith(name[len("fused_ce_"):])},
            **(dict(matmul_ms=main_row["matmul_ms"])
               if name == "fused_ce_fwd" else dict(
                   dx_plus_dw_ms=main_row["dx_plus_dw_ms"],
                   dense_bwd_profiled_ms=ce_dense["profiled_ms"],
                   dense_bwd_matmul_ms=ce_dense["matmul_ms"]))))
    # The ring kernels' time is one layer's W=4 launches at the training
    # path's shape; SDPA is the one PyTorch call for the same attention.
    ring_shape = {k: ring["main"][k]
                  for k in ("B", "S_local", "H", "hd", "W", "causal")}
    for name, which, line, function, worst, extra in (
            ("ring_attention_fwd", "fwd", 200,
             "_fused_ring_fwd (_block_kernel :148, merge :232)",
             ring["worst"]["fwd"], {}),
            ("ring_attention_bwd", "bwd", 242,
             "_fused_ring_bwd (_splash_attention_bwd_dkv :270)",
             ring["worst"]["bwd_abs"],
             {"max_rel_err": ring["worst"]["bwd_rel"]})):
        timed = ring["main"][which]
        kernels.append(entry(
            name, f"ray_tpu_torch/csrc/{name}.cu",
            f"ray_tpu/ops/ring_attention.py:{line}",
            f"ray_tpu.ops.ring_attention.{function}", [8 if which == "fwd"
                                                       else 9],
            paths(name), worst, timed, ring["whole"][f"{which}_ms"]["sdpa"],
            ring_shape, ms_unit="one layer's W=4 launches",
            launches_per_layer=timed["launches"],
            per_launch=[{key: launch[key] for key in launch
                         if key in ("step", "pairs")
                         or key.startswith(which)}
                        for launch in ring["main"]["per_launch"]],
            whole_ring_ms=ring["whole"][f"{which}_ms"],
            bound_ms_accumulate=timed["bound_ms_accumulate"],
            resources={key: res for key, res in resources.items()
                       if key.split()[0] in (("fwd",) if which == "fwd"
                                             else ("dkv", "dq"))},
            **extra))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
