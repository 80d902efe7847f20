#!/usr/bin/env python3
"""Holds the attention kernels of two source trees against each other on one
NVIDIA GPU: the ring step kernels bit for bit, the splash forward by how far
each tree is from the plain version and from the other tree.

    python3 scripts/torch_ring_compare.py --tree parent=smoke_tree/parent \\
        --tree change=. [--work ray_tpu_torch/_build/ring_compare]

For each tree, in its own process (both hold a package named
``ray_tpu_torch``) and in the order given, it builds the ring kernels and
the splash forward from that tree's ``csrc/``, prints their ptxas lines and
what each kernel holds on an SM (registers, spill bytes, static and dynamic
shared bytes, resident blocks per SM; the ring's for head_dim 64 and 128
and each step kind, the splash forward's for each head_dim), and saves,
all from one seed:

- a whole W=4 ring forward and backward (o, lse, dq, dk, dv) at
  ``chip_smoke.py``'s four ``RING_SHAPES``;
- the splash forward's o and lse at ``chip_smoke.py``'s ``KERNEL_SHAPES``
  (q, k, v split from a fused qkv), printing each shape's largest
  difference from ``attention_reference`` in that tree (``splash_vs_plain``).

Then it prints, per shape and tensor, whether the trees agree bit for bit
and by how much they differ (``bits``), and ``ring_bit_equal`` (true when
every ring tensor agrees). The splash forward sums in the order its kernel
takes, so two designs are not expected to agree bit for bit. A tree whose
splash source exports no ``splash_attention_fwd_resources`` gets one from a
probe source that includes it. Saved results go to ``--work`` (a directory
the repository's .gitignore lists).
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
# chip_smoke.py KERNEL_SHAPES: (B, S, H, hd, causal).
SPLASH_SHAPES = [
    (16, 1024, 12, 64, True),
    (8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
    (1, 1024, 12, 64, True), (1, 1024, 12, 64, False),
    (1, 1000, 12, 64, True), (2, 1000, 12, 64, False),
    (1, 7, 12, 64, True), (3, 7, 12, 64, False),
    (2, 512, 8, 128, True), (2, 512, 8, 128, False),
]
RING = ("ring_attention_fwd", "ring_attention_bwd")
SPLASH = "splash_attention_fwd"
RING_TENSORS = ("o", "lse", "dq", "dk", "dv")

# The resources entry for a splash forward source that lacks one: the
# mma.sync body's kernel (attention_fwd.cuh) at the shared size it launches
# with.
_PROBE = """
#include "{source}"
extern "C" int splash_attention_fwd_resources(int head_dim, int* out) {{
  if (head_dim == 64)
    return (int)kernel_resources(attention_fwd_kernel<64, SplashMode>,
                                 kThreads, smem_bytes<64>(), out);
  if (head_dim == 128)
    return (int)kernel_resources(attention_fwd_kernel<128, SplashMode>,
                                 kThreads, smem_bytes<128>(), out);
  return (int)cudaErrorInvalidValue;
}}
"""
_FIELDS = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
           "blocks_per_sm")


def _entry(lib, name: str, n_args: int):
    import ctypes

    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] * (n_args - 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, args, n_kernels: int):
    import ctypes

    buf = (ctypes.c_int * (5 * n_kernels))()
    err = fn(*args, ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}{args}: CUDA error {err}")
    return [dict(zip(_FIELDS, buf[5 * i:5 * i + 5])) for i in range(n_kernels)]


def _resources(kernel_build, work: Path) -> dict:
    """What each ring kernel and the splash forward hold on an SM."""
    import ctypes

    res = {}
    for name in RING:
        fn = _entry(kernel_build.load(name), f"{name}_resources", 3)
        n_kernels = 1 if name.endswith("fwd") else 2
        for hd in (64, 128):
            for first in (0, 1):
                res[f"{name} hd{hd}_first{first}"] = _call(fn, (hd, first),
                                                           n_kernels)
    lib = kernel_build.load(SPLASH)
    if not hasattr(lib, f"{SPLASH}_resources"):
        src = work / f"probe_{SPLASH}.cu"
        src.write_text(_PROBE.format(
            source=kernel_build.CSRC_DIR / f"{SPLASH}.cu"))
        so = work / f"libprobe_{SPLASH}.so"
        out = subprocess.run(
            kernel_build.nvcc_command(kernel_build.find_nvcc(), src, so),
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"probe build failed:\n{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(str(so))
    fn = _entry(lib, f"{SPLASH}_resources", 2)
    for hd in (64, 128):
        res[f"{SPLASH} hd{hd}"] = _call(fn, (hd,), 1)
    return res


def worker(tree: Path, label: str, work: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from ray_tpu_torch._private import kernel_build
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import ring_attention as ra

    if not Path(kernel_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernel_build.__file__}, not {tree}'s")
    kernel_build.build([*RING, SPLASH])
    for name in (*RING, SPLASH):
        for line in kernel_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"{label} ptxas {name}: {line.strip()}", flush=True)
    print(f"{label} resources " + json.dumps(_resources(kernel_build, work)),
          flush=True)

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
        saved[f"ring {(B, shard, H, hd, causal)}"] = {
            n: t.cpu() for n, t in zip(RING_TENSORS, (o, lse, dq, dk, dv))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    vs_plain = {}
    for B, S, H, hd, causal in SPLASH_SHAPES:
        qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        o, lse = attention.splash_attention(q, k, v, causal=causal,
                                            return_lse=True)
        o_ref, lse_ref = attention.attention_reference(q, k, v, causal=causal)
        shape = str((B, S, H, hd, causal))
        vs_plain[shape] = dict(
            o=(o.float() - o_ref.float()).abs().max().item(),
            lse=(lse - lse_ref).abs().max().item())
        saved[f"splash {shape}"] = {"o": o.cpu(), "lse": lse.cpu()}
        del qkv, q, k, v, o, lse, o_ref, lse_ref
    print(f"{label} splash_vs_plain " + json.dumps(vs_plain), flush=True)
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
                    max_abs_diff=(x[shape][n].float()
                                  - y[shape][n].float()).abs().max().item(),
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
    finite = True
    for label, _ in trees[1:]:
        diff = compare(work, base, label)
        print(f"bits {base} vs {label} " + json.dumps(diff), flush=True)
        ring_equal = all(d["equal"] for s, per in diff.items()
                         if s.startswith("ring") for d in per.values())
        print(f"ring_bit_equal {base} vs {label} {json.dumps(ring_equal)}",
              flush=True)
        finite &= all(d["finite"] for per in diff.values()
                      for d in per.values())
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
