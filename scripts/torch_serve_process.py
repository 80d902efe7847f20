#!/usr/bin/env python3
"""The process tier on the card alone: ``chip_smoke.py``'s serving phase and
its ``serve_process`` phase, without the kernel, training and other
serving phases.

    python3 scripts/torch_serve_process.py

Builds the kernels, prints the card's name and power limit, serves GPT-2
124M in-process (the ``serve`` line, whose answers and tokens the process
tier is held to), then runs ``phase_serve_process``: process tasks, a
process actor killed and restarted, thread and process replicas at one
and two replicas under 8 HTTP clients in turns, an SSE stream from a
process replica, and the check that no worker outlives the runtime. Each
phase prints its JSON line; any failed gate exits non-zero.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_process: torch finds no CUDA device",
              file=sys.stderr)
        return 2
    from ray_tpu_torch._private import kernel_build

    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    kernel_build.build()
    print(f"build_seconds {time.perf_counter() - t0:.3f}", flush=True)
    weights = chip_smoke.serve_weights()
    inproc = chip_smoke.phase_serve(weights)
    chip_smoke.phase_serve_process(weights, inproc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
