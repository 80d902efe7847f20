#!/usr/bin/env python3
"""Where the time of one GPT-2 training step goes on the GPU (the port).

    python3 scripts/torch_profile_train.py [--trace-dir DIR]

Builds GPT-2 124M (``GPTConfig(remat_policy="attn_outside",
scan_layers=False)``, bf16, random weights from seed 0) with
``ray_tpu_torch`` and runs ``make_train_step`` with ``make_optimizer(3e-4)``
at (16, 1024), 3 steps under ``torch.profiler`` after 3 warm-up steps, once
with the dense loss, once with ``loss_impl="fused"`` and once through the
ring (``attn_impl="ring"``, dense loss, a seq axis of 4 ranks folded onto
the card by ``jit_train_step(mesh=)``). For each it prints one JSON line:
the host wall time per step, the device busy time per step (the sum of the
kernels' own device times), the device's idle share, launches per step,
the device time by kind of kernel (the port's kernels by name, cuBLAS
matmuls, everything else), the optimizer update's own device time (CUDA
events around it alone) and the kernels that take the most device time. Needs a CUDA device; with
``--trace-dir`` it also writes a Chrome trace of each run there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from torch_profile_serve import device_kernel_times  # noqa: E402

# Each kind's kernel names: a name is of the kind when it holds every
# fragment of one of the alternatives; kinds are checked in order. The
# splash and ring backward kernels share their body (csrc/attention_bwd.cuh)
# and differ by the mode tag in their names; the ring's kernels are named
# after their source.
KINDS = (("splash_attention_fwd", (("splash_attention_fwd_kernel",),)),
         ("splash_attention_bwd", (("attention_bwd_", "SplashMode"),
                                   ("attention_bwd_delta_kernel",))),
         ("ring_attention_fwd", (("ring_attention_fwd_kernel",),)),
         ("ring_attention_bwd", (("ring_attention_bwd_",),)),
         ("fused_ce", (("fused_ce_",),)),
         ("matmul", (("gemm",), ("xmma",), ("cutlass",), ("nvjet",),
                     ("cublas",))))
BATCH = 16  # per chip, as bench.py
STEPS = 3   # profiled steps per path
# (attn_impl, loss_impl, ranks of the seq axis): the paths chip_smoke.py
# trains at full width.
PATHS = (("auto", "dense", 1), ("auto", "fused", 1), ("ring", "dense", 4))


def kind_of(name: str) -> str:
    for kind, alternatives in KINDS:
        if any(all(f in name for f in alt) for alt in alternatives):
            return kind
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_map
    from ray_tpu_torch.parallel import MeshSpec, jit_train_step

    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    config = gpt2.GPTConfig(remat_policy="attn_outside", scan_layers=False)
    init = gpt2.init_params(config, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(
        rng.integers(0, 50257, (BATCH, config.seq_len + 1)),
        device="cuda")
    tokens, targets = toks[:, :-1], toks[:, 1:]

    for attn, impl, seq_axis in PATHS:
        cfg = dataclasses.replace(config, attn_impl=attn, loss_impl=impl)
        params = tree_map(lambda p: p.detach().clone(), init)
        optimizer = gpt2.make_optimizer(3e-4)
        state = optimizer.init(params)
        step = jit_train_step(gpt2.make_train_step(cfg, optimizer),
                              mesh=MeshSpec(seq=seq_axis))
        for _ in range(3):  # warm-up
            params, state, loss = step(params, state, tokens, targets)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                params, state, loss = step(params, state, tokens, targets)
            float(loss)
            wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        kernels = device_kernel_times(prof)
        busy_ms = sum(t for t, _ in kernels.values()) / 1e3 / STEPS
        by_kind = {}
        for name, (t, _) in kernels.items():
            k = kind_of(name)
            by_kind[k] = by_kind.get(k, 0.0) + t / 1e3 / STEPS

        # The optimizer update alone, on gradients of the right shapes.
        grads = tree_map(lambda p: torch.full_like(p, 1e-4), params)
        state_copy = dict(state)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        optimizer.update(grads, state_copy, params)
        end.record()
        end.synchronize()

        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
        print(json.dumps({
            "loss_impl": impl, "attn_impl": attn, "seq_axis": seq_axis,
            "batch": BATCH, "seq_len": config.seq_len,
            "device": torch.cuda.get_device_name(0),
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "launches_per_step": sum(c for _, c in kernels.values())
                                 / STEPS,
            "device_ms_by_kind": by_kind,
            "optimizer_update_ms": start.elapsed_time(end),
            "top_kernels": [
                {"name": k[:90], "ms_per_step": t / 1e3 / STEPS,
                 "calls_per_step": c / STEPS}
                for k, (t, c) in top],
        }), flush=True)
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.trace_dir,
                             f"train_step_{attn}_{impl}.json"))
        del params, state, grads, state_copy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
