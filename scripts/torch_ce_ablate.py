#!/usr/bin/env python3
"""Where the fused-CE backward's time goes, by ablation, on one NVIDIA GPU.

    python3 scripts/torch_ce_ablate.py [--tree .] [--work DIR]

``ncu`` does not run on the card's machine, so this takes the kernel
apart instead: it compiles ``csrc/fused_ce.cu`` of the tree once as it is
and once for each ablation below (one part of the backward's tile loop
removed, by a textual edit whose anchor must exist), all at once, then
times ``fused_ce_dx`` and ``fused_ce_dw`` of every library at GPT-2 124M's
training shape (N=16384, D=768, V=50304) by CUDA-graph replay
(``chip_smoke.py:device_ms``), in turns: full, each ablation, full. An
ablated kernel computes a wrong result; only its time is read. What an
ablation saves is an upper bound on what hiding that part could gain.

- ``no_exp``: p from the logits by one multiply-add, no exp2;
- ``no_exchange``: no partial logits through shared memory and no
  barrier between them (each warpgroup keeps its own partial);
- ``no_logits``: no logits wgmma;
- ``no_product``: no P S wgmma;
- ``hot_stream``: every block streams the same two tiles, which stay in
  L2, in place of walking the whole streamed operand;
- ``no_load``: no streamed tile after the first two is loaded or waited
  for (the block computes on the two it has): what any change to the
  loads (TMA multicast among them) could gain at most.

Prints one JSON line per library and a last line with each ablation's
saving against the mean of the two full runs. Libraries and logs go to
``--work`` (a directory the repository's .gitignore lists).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

N, D, V = 16384, 768, 50304

_EXP = ("float p = exp2f(z[4 * q + e] * kLog2e - ls) - (hot ? 1.f : 0.f);",
        "float p = z[4 * q + e] * kLog2e - ls - (hot ? 1.f : 0.f);")
ABLATIONS = {
    "no_exp": [_EXP],
    "no_exchange": [("if constexpr (L::kGroups > 1) {",
                     "if constexpr (false) {")],
    "no_logits": [("for (int kk = 0; kk < L::kCols / 16; ++kk)",
                   "for (int kk = 0; kk < 0; ++kk)")],
    "no_product": [("          wgmma_rs<kNW>(acc[c], pa[kt],",
                    "          if (false) wgmma_rs<kNW>(acc[c], pa[kt],")],
    "hot_stream": [("j * kStrRows, str_bar + buf);",
                    "(j % kStages) * kStrRows, str_bar + buf);")],
    "no_load": [("    mbar_wait(str_bar + buf, (j / kStages) & 1);",
                 "    if (j < kStages) mbar_wait(str_bar + buf, 0);"),
                ("if (threadIdx.x == 0) load_streamed(j + kStages);", "")],
}


def _sources(tree: Path, work: Path) -> dict:
    """One copy of csrc/ per variant, the ablation applied to fused_ce.cu."""
    import shutil

    csrc = tree / "ray_tpu_torch" / "csrc"
    text = (csrc / "fused_ce.cu").read_text()
    out = {}
    for name, edits in {"full": [], **ABLATIONS}.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old!r} found "
                                   f"{src.count(old)} times")
            src = src.replace(old, new)
        d = work / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        (d / "fused_ce.cu").write_text(src)
        out[name] = d / "fused_ce.cu"
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--work", default="ray_tpu_torch/_build/ce_ablate")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from ray_tpu_torch._private import kernel_build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_build.find_nvcc()
    procs = {}
    for name, src in _sources(tree, work).items():
        so = work / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            kernel_build.nvcc_command(nvcc, src, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        (work / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            print(f"{name} build failed:\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        for fn in (lib.fused_ce_dx, lib.fused_ce_dw):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib

    print(chip_smoke.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, w, t = chip_smoke._ce_inputs(gen, N, D, V)
    t = t.to(torch.int32)
    from ray_tpu_torch.ops import fused_ce

    lse, _ = fused_ce.ce_fwd(x, w, t)
    dx = torch.empty((N, D), dtype=torch.float32, device="cuda")
    dw = torch.empty((V, D), dtype=torch.float32, device="cuda")

    def run(fn, out):
        def call():
            err = fn(x.data_ptr(), w.data_ptr(), t.data_ptr(), lse.data_ptr(),
                     out.data_ptr(), N, V, D,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return call

    order = ["full", *ABLATIONS, "full"]
    times = {}
    for i, name in enumerate(order):
        lib = libs[name]
        row = dict(variant=name,
                   dx_ms=chip_smoke.device_ms(run(lib.fused_ce_dx, dx),
                                              iters=3),
                   dw_ms=chip_smoke.device_ms(run(lib.fused_ce_dw, dw),
                                              iters=3))
        times[f"{name}{i}" if name == "full" else name] = row
        print("ablate " + json.dumps(row), flush=True)
    full = [r for k, r in times.items() if k.startswith("full")]
    base = {k: sum(r[k] for r in full) / len(full) for k in ("dx_ms", "dw_ms")}
    print("ablate_saving " + json.dumps({
        name: {k: base[k] - times[name][k] for k in base}
        for name in ABLATIONS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
