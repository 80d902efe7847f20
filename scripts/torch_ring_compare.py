#!/usr/bin/env python3
"""Holds the ring step kernels of two source trees against each other on one
NVIDIA GPU.

    python3 scripts/torch_ring_compare.py --tree parent=smoke_tree/parent \\
        --tree change=. [--work ray_tpu_torch/_build/ring_compare]

For each tree, in its own process (both hold a package named
``ray_tpu_torch``) and in the order given, it builds the ring kernels from
that tree's ``csrc/``, prints their ptxas lines and what each ring kernel
holds on an SM (registers, spill bytes, static and dynamic shared bytes,
resident blocks per SM, for head_dim 64 and 128 and each step kind), and
saves a whole W=4 ring forward and backward (o, lse, dq, dk, dv) at
``chip_smoke.py``'s four ``RING_SHAPES``, all from one seed. Then it prints,
per shape and tensor, whether the trees agree bit for bit and by how much
they differ. A tree whose ring sources export no ``*_resources`` entry gets
one from a probe source that includes its ring source. Saved results go to
``--work`` (a directory the repository's .gitignore lists).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

W = 4
# chip_smoke.py RING_SHAPES: (B, S_local, H, hd, causal).
RING_SHAPES = [(16, 256, 12, 64, True), (2, 250, 12, 64, True),
               (2, 256, 8, 128, True), (4, 256, 12, 64, False)]
KINDS = ("ring_attention_fwd", "ring_attention_bwd")

# The resources entry for ring sources that lack one: each kernel of a step
# at the one dynamic shared size it launches with.
_PROBE = """
#include "{source}"
namespace {{
template <typename K>
cudaError_t probe(K kernel, int threads, int smem, int* out) {{
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  out[0] = a.numRegs; out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes; out[3] = smem; out[4] = blocks;
  return err;
}}
{kernels}}}  // namespace
extern "C" int {name}_resources(int head_dim, int first, int* out) {{
  (void)first;
  if (head_dim == 64) return {which}<64>(out);
  if (head_dim == 128) return {which}<128>(out);
  return (int)cudaErrorInvalidValue;
}}
"""
_PROBE_KERNELS = {
    "fwd": """template <int HD> int fwd(int* out) {
  return (int)probe(attention_fwd_kernel<HD, RingStepMode>, kThreads,
                    smem_bytes<HD>(), out);
}
""",
    "bwd": """template <int HD> int bwd(int* out) {
  cudaError_t err = probe(attention_bwd_dkv_kernel<HD, RingStepMode>,
                          kThreads, smem_bytes<HD>(), out);
  if (err != cudaSuccess) return (int)err;
  return (int)probe(attention_bwd_dq_kernel<HD, RingStepMode>, kThreads,
                    smem_bytes<HD>(), out + 5);
}
"""}
_FIELDS = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
           "blocks_per_sm")


def _resources(kernel_build, name: str, work: Path):
    """{(hd, first): [kernel resources]} of ring kernel ``name``."""
    import ctypes

    lib = kernel_build.load(name)
    entry = f"{name}_resources"
    if not hasattr(lib, entry):
        src = work / f"probe_{name}.cu"
        which = name.rsplit("_", 1)[1]
        src.write_text(_PROBE.format(
            source=kernel_build.CSRC_DIR / f"{name}.cu", name=name,
            which=which, kernels=_PROBE_KERNELS[which]))
        so = work / f"libprobe_{name}.so"
        out = subprocess.run(
            kernel_build.nvcc_command(kernel_build.find_nvcc(), src, so),
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"probe build failed:\n{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_kernels = 1 if name.endswith("fwd") else 2
    res = {}
    for hd in (64, 128):
        for first in (0, 1):
            buf = (ctypes.c_int * (5 * n_kernels))()
            err = fn(hd, first, ctypes.addressof(buf))
            if err != 0:
                raise RuntimeError(f"{entry}({hd}, {first}): CUDA error {err}")
            res[f"hd{hd}_first{first}"] = [
                dict(zip(_FIELDS, buf[5 * i:5 * i + 5]))
                for i in range(n_kernels)]
    return res


def worker(tree: Path, label: str, work: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from ray_tpu_torch._private import kernel_build
    from ray_tpu_torch.ops import ring_attention as ra

    if not Path(kernel_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernel_build.__file__}, not {tree}'s")
    kernel_build.build(list(KINDS))
    for name in KINDS:
        for line in kernel_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"{label} ptxas {name}: {line.strip()}", flush=True)
        print(f"{label} resources {name} "
              + json.dumps(_resources(kernel_build, name, work)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    saved = {}
    for B, shard, H, hd, causal in RING_SHAPES:
        S = W * shard
        qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        do = torch.randn(q.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        o, lse = ra.ring_forward(q, k, v, world=W, causal=causal)
        dq, dk, dv = ra.ring_backward(q, k, v, o, lse, do, world=W,
                                      causal=causal)
        saved[str((B, shard, H, hd, causal))] = {
            n: t.cpu() for n, t in zip(("o", "lse", "dq", "dk", "dv"),
                                       (o, lse, dq, dk, dv))}
    torch.save(saved, work / f"bits_{label}.pt")


def compare(work: Path, a: str, b: str) -> dict:
    import torch

    x = torch.load(work / f"bits_{a}.pt")
    y = torch.load(work / f"bits_{b}.pt")
    out = {}
    for shape in x:
        out[shape] = {
            n: dict(equal=torch.equal(x[shape][n], y[shape][n]),
                    n_differ=int((x[shape][n] != y[shape][n]).sum()),
                    max_abs_diff=(x[shape][n] - y[shape][n]).abs().max().item(),
                    finite=bool(torch.isfinite(y[shape][n]).all()))
            for n in x[shape]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="label=directory, in the order to run")
    ap.add_argument("--work", default="ray_tpu_torch/_build/ring_compare")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"))
    args = ap.parse_args()
    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    if args.worker:
        worker(Path(args.worker[0]).resolve(), args.worker[1], work)
        return 0
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) < 2:
        ap.error("give two trees or more")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for label, tree in trees:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--work", str(work),
             "--worker", tree, label], env=env)
        if res.returncode != 0:
            print(f"worker {label} failed ({res.returncode})", file=sys.stderr)
            return 1
    base = trees[0][0]
    worst_ok = True
    for label, _ in trees[1:]:
        diff = compare(work, base, label)
        print(f"bits {base} vs {label} " + json.dumps(diff), flush=True)
        worst_ok &= all(d["finite"] for s in diff.values() for d in s.values())
    return 0 if worst_ok else 1


if __name__ == "__main__":
    sys.exit(main())
