"""GPT-2 124M training throughput and MFU on one GPU.

    python3 -m ray_tpu_torch.bench [--loss-impl dense|fused] [--steps 10]

The counterpart of the JAX package's root ``bench.py`` (:41-135) on one
card: ``GPTConfig(remat_policy="attn_outside", scan_layers=False)``, bf16,
``make_optimizer(3e-4)``, B=16, S=1024, one batch from a numpy seed repeated
every step; 3 warm-up steps, then the median of 3 windows of ``--steps``
steps, each window ending in ``float(loss)`` (which waits for the device).
Prints one JSON line:

    {"metric": "gpt2_124m_train_mfu_cuda", "value": <MFU %>, ...}

MFU is model flops (``flops_per_token``) per second over the card's dense
bf16 peak, from ``ray_tpu_torch._private.peaks``; a card that is not in that
table raises rather than being measured against a guessed peak. On the CPU
(``--tiny --device cpu``, for tests at a small size and B=2) there is no
peak, and the line's ``value`` is null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.peaks import peaks_for
from ray_tpu_torch.models import gpt2

BATCH = 16  # per chip, as the JAX bench.py fixes it
TINY_BATCH = 2


def run(config: gpt2.GPTConfig, batch: int, steps: int, windows: int = 3,
        warmup: int = 3, device=None, seed: int = 0) -> dict:
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    # Dense bf16 peak flop/s; a card not in the table raises KeyError.
    peak = peaks_for(name)[1] if dev.type == "cuda" else None
    params = gpt2.init_params(config, seed=seed, device=dev)
    optimizer = gpt2.make_optimizer(learning_rate=3e-4)
    opt_state = optimizer.init(params)
    step = gpt2.make_train_step(config, optimizer)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(
        rng.integers(0, config.vocab_size, (batch, config.seq_len + 1)),
        dtype=torch.long, device=dev)
    tokens, targets = toks[:, :-1], toks[:, 1:]

    t0 = time.perf_counter()
    for i in range(warmup):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        if i == 0:
            first_step_s = time.perf_counter() - t0  # includes the kernel build
    warm_loss = float(loss)
    print(f"warmup {time.perf_counter() - t0:.2f}s (first step "
          f"{first_step_s:.2f}s) loss={warm_loss:.4f}", file=sys.stderr)

    times: List[float] = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, tokens, targets)
        final_loss = float(loss)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    tokens_per_s = steps * batch * config.seq_len / dt
    flops = gpt2.flops_per_token(config) * tokens_per_s
    mfu = None if peak is None else 100.0 * flops / peak
    return {
        "metric": "gpt2_124m_train_mfu_cuda",
        "value": mfu,
        "unit": "%",
        "tokens_per_sec_per_chip": tokens_per_s,
        "steps_per_sec": steps / dt,
        "loss": final_loss,
        "loss_impl": config.loss_impl,
        "batch": batch,
        "seq_len": config.seq_len,
        "window_s": times,
        "first_step_s": first_step_s,
        "device": name,
        "peak_flops": peak,
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loss-impl", choices=("dense", "fused"), default="dense")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps per timed window (3 windows)")
    ap.add_argument("--device", default=None,
                    help="default: the first CUDA device; 'cpu' for tests")
    ap.add_argument("--tiny", action="store_true",
                    help=f"GPTConfig.tiny() in fp32 at B={TINY_BATCH} (a CPU "
                         "test size)")
    args = ap.parse_args(argv)
    config = (dataclasses.replace(gpt2.GPTConfig.tiny(), dtype=torch.float32,
                                  logits_dtype=torch.float32)
              if args.tiny else gpt2.GPTConfig())
    config = dataclasses.replace(config, remat_policy="attn_outside",
                                 scan_layers=False, loss_impl=args.loss_impl)
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = TINY_BATCH if args.tiny else BATCH
    print(json.dumps(run(config, batch, args.steps, device=args.device)),
          flush=True)


if __name__ == "__main__":
    main()
