#!/usr/bin/env python3
"""Where a fused-CE kernel's time goes, by ablation, on one NVIDIA GPU.

    python3 scripts/torch_ce_ablate.py [--kernel bwd|fwd] [--tree .] \
        [--work DIR]

``ncu`` does not run on the card's machine, so this takes the kernel
apart instead: it compiles ``csrc/fused_ce.cu`` of the tree once as it is
and once for each ablation below (one part of the kernel removed, by a
textual edit whose anchor must exist exactly once), all at once, then times
the kernel of every library at GPT-2 124M's training shape (N=16384,
D=768, V=50304) by CUDA-graph replay (``chip_smoke.py:device_ms``), in
turns: full, each ablation, full. An ablated kernel computes a wrong
result; only its time is read. What an ablation saves is an upper bound on
what hiding that part could gain.

``--kernel bwd`` (the default) times ``fused_ce_dx`` and ``fused_ce_dw``:

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

``--kernel fwd`` times ``fused_ce_fwd``:

- ``no_exp``: each logit added to the sum by one multiply-add, no exp2;
- ``no_logits``: no logits wgmma;
- ``hot_stream``: every block streams the first two vocab tiles over and
  over, which stay in L2, in place of walking all of W;
- ``no_load``: no W chunk after the first ring's worth is loaded or
  waited for: what any change to the loads could gain at most;
- ``no_multicast``: clusters of one block, each loading every W chunk
  whole (what the multicast saves);
- ``no_pingpong``: one consumer warpgroup, which exponentiates each tile
  between its products (what the second warpgroup saves);
- ``step1``: both of the last two, the design's first step (one block per
  64 rows, one consumer warpgroup);

and the designs tried and not kept:

- ``cluster4``: clusters of four blocks, each loading a quarter of every
  W chunk;
- ``cluster_release``: each buffer's release an mbarrier arrival with
  ``.release.cluster`` and the producer's wait ``.acquire.cluster``, in
  place of the default CTA scope.

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
_FWD_SUM = """\
        l_a += fast_exp2(fmaf(z[4 * q], kLog2e, -m_a)) +
               fast_exp2(fmaf(z[4 * q + 1], kLog2e, -m_a));
        l_b += fast_exp2(fmaf(z[4 * q + 2], kLog2e, -m_b)) +
               fast_exp2(fmaf(z[4 * q + 3], kLog2e, -m_b));"""
_ONE_BLOCK = ("constexpr int kFwdCluster = 2;",
              "constexpr int kFwdCluster = 1;")
_ONE_GROUP = ("constexpr int kFwdGroups = 2;", "constexpr int kFwdGroups = 1;")
_ACQUIRE_WAIT = """// ---- The forward (lse and tgt) ----

__device__ __forceinline__ void mbar_wait_acquire_cluster(uint64_t* bar,
                                                          uint32_t parity) {
  asm volatile(
      "{\\n"
      ".reg .pred p;\\n"
      "WAIT:\\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\\n"
      "@!p bra WAIT;\\n"
      "}\\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}"""
# An edit is (old, new) in fused_ce.cu or (file, old, new) in another file
# of csrc/.
ABLATIONS = {
    "bwd": {
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
    },
    "fwd": {
        "no_exp": [(_FWD_SUM, _FWD_SUM.replace("fast_exp2(fmaf(", "(fmaf("))],
        "no_logits": [("          wgmma_64x256x16_ss(z, desc_at(",
                       "          if (false) wgmma_64x256x16_ss(z, desc_at(")],
        "hot_stream": [("(i / L::kChunks) * kVocabTile + rank * kPart",
                        "(i / L::kChunks % 2) * kVocabTile + rank * kPart")],
        "no_load": [("      for (int i = 0; i < n_chunks; ++i) {",
                     "      for (int i = 0; i < n_chunks && i < kFwdStages;"
                     " ++i) {"),
                    ("        mbar_wait(full + s, (i / kFwdStages) & 1);",
                     "        if (i < kFwdStages) mbar_wait(full + s, 0);")],
        "no_multicast": [_ONE_BLOCK],
        "no_pingpong": [_ONE_GROUP],
        "step1": [_ONE_GROUP, _ONE_BLOCK],
        "cluster4": [("constexpr int kFwdCluster = 2;",
                      "constexpr int kFwdCluster = 4;")],
        "cluster_release": [
            ("wgmma_sm90.cuh", "mbarrier.arrive.shared::cluster.b64",
             "mbarrier.arrive.release.cluster.shared::cluster.b64"),
            ("          mbar_wait(empty + s, (i / kFwdStages - 1) & 1);",
             "          mbar_wait_acquire_cluster(empty + s,\n"
             "                                    (i / kFwdStages - 1) & 1);"),
            ("// ---- The forward (lse and tgt) ----", _ACQUIRE_WAIT)],
    },
}
# Each kernel's C entries, timed in this order.
ENTRIES = {"bwd": ("fused_ce_dx", "fused_ce_dw"), "fwd": ("fused_ce_fwd",)}


def _sources(tree: Path, work: Path, ablations: dict) -> dict:
    """One copy of csrc/ per variant, the ablation applied to fused_ce.cu."""
    import shutil

    csrc = tree / "ray_tpu_torch" / "csrc"
    out = {}
    for name, edits in {"full": [], **ablations}.items():
        d = work / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        for edit in edits:
            fname, old, new = edit if len(edit) == 3 else ("fused_ce.cu",
                                                           *edit)
            src = (d / fname).read_text()
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old!r} found "
                                   f"{src.count(old)} times in {fname}")
            (d / fname).write_text(src.replace(old, new))
        out[name] = d / "fused_ce.cu"
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("bwd", "fwd"), default="bwd")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--work", default="ray_tpu_torch/_build/ce_ablate")
    args = ap.parse_args()
    ablations, entries = ABLATIONS[args.kernel], ENTRIES[args.kernel]
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from ray_tpu_torch._private import kernel_build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    work = Path(args.work).resolve() / args.kernel
    work.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_build.find_nvcc()
    procs = {}
    for name, src in _sources(tree, work, ablations).items():
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
        for fn in (getattr(lib, e) for e in entries):
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
    # Each entry's outputs: (lse, tgt) for fwd; dx or dW after lse for dx, dW.
    outs = {"fused_ce_fwd": (torch.empty(N, device="cuda"),
                             torch.empty(N, device="cuda")),
            "fused_ce_dx": (lse, torch.empty((N, D), dtype=torch.float32,
                                             device="cuda")),
            "fused_ce_dw": (lse, torch.empty((V, D), dtype=torch.float32,
                                             device="cuda"))}

    def run(lib, entry):
        fn = getattr(lib, entry)
        a, b = outs[entry]

        def call():
            err = fn(x.data_ptr(), w.data_ptr(), t.data_ptr(), a.data_ptr(),
                     b.data_ptr(), N, V, D,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return call

    keys = [f"{e[len('fused_ce_'):]}_ms" for e in entries]
    order = ["full", *ablations, "full"]
    times = {}
    for i, name in enumerate(order):
        row = dict(variant=name)
        for entry, key in zip(entries, keys):
            row[key] = chip_smoke.device_ms(run(libs[name], entry), iters=3)
        times[f"{name}{i}" if name == "full" else name] = row
        print("ablate " + json.dumps(row), flush=True)
    full = [r for k, r in times.items() if k.startswith("full")]
    base = {k: sum(r[k] for r in full) / len(full) for k in keys}
    print("ablate_saving " + json.dumps({
        name: {k: base[k] - times[name][k] for k in base}
        for name in ablations}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
