#!/usr/bin/env python3
"""Holds the attention and fused-CE kernels of two source trees against each
other on one NVIDIA GPU: the ring step kernels bit for bit, the splash
forward and backward and the CE forward and backward by how far each tree
is from the plain version and from the other tree, and the splash
backward's and the CE kernels' device times.

    python3 scripts/torch_ring_compare.py --tree parent=smoke_tree/parent \\
        --tree change=. [--work ray_tpu_torch/_build/ring_compare]

For each tree, in its own process (both hold a package named
``ray_tpu_torch``) and in the order given, it builds the ring kernels, the
splash forward and backward and the fused CE kernels from that tree's
``csrc/``, prints their ptxas lines, a digest of the ring libraries' machine
code (``sass``, from ``cuobjdump -sass``, names left out) and what each
kernel holds on an SM (registers, spill bytes, static and dynamic shared
bytes, resident blocks per SM; the ring's for head_dim 64 and 128 and each
step kind, the splash kernels' for each head_dim, the CE kernels for each
width: dx and dW, and the forward where the tree exports
``fused_ce_fwd_resources``), and saves, all from one seed:

- a whole W=4 ring forward and backward (o, lse, dq, dk, dv) at
  ``chip_smoke.py``'s four ``RING_SHAPES``;
- the splash forward's o and lse at ``chip_smoke.py``'s ``KERNEL_SHAPES``
  (q, k, v split from a fused qkv), printing each shape's largest
  difference from ``attention_reference`` in that tree (``splash_vs_plain``);
- the splash backward's dq, dk and dv at ``chip_smoke.py``'s
  ``BWD_SHAPES``, printing each gradient's largest difference from
  ``attention_bwd_reference`` over the reference's largest entry
  (``splash_bwd_vs_plain``), and the backward's device time (CUDA-graph
  replay, as ``chip_smoke.py:device_ms``) at ``BWD_TIMED``
  (``splash_bwd_ms``);
- the fused CE forward's lse and tgt and the backward's dx and dW at
  ``chip_smoke.py``'s ``CE_SHAPES``, printing lse's and tgt's largest
  difference from ``ce_fwd_reference`` and dx's and dW's from their plain
  versions over the reference's largest entry (``ce_vs_plain``), and the
  three kernels' device times at the training shape (``ce_ms``).

Then it prints, per shape and tensor, whether the trees agree bit for bit
and by how much they differ (``bits``), ``ring_bit_equal`` (true when every
ring tensor agrees), ``ring_sass_equal`` (true when the ring libraries'
machine code agrees), ``ce_bwd_sass_equal`` (true when the CE backward
kernels' machine code agrees), ``ce_fwd_diff`` (lse's and tgt's largest
difference between the trees per shape, beside each tree's largest
difference from ``ce_fwd_reference``) and ``ce_grad_diff`` (dx's and dW's
largest difference between the trees per shape). The splash kernels and the CE
kernels sum in the order their design takes, so two designs are not
expected to agree bit for bit; dx and dW read the forward's lse, so a new
forward moves their bits too.
A tree whose splash or CE sources export no ``*_resources`` entry gets one
from a probe source that includes them. Give a tree twice, in turns (parent, change, change,
parent), to see the spread of the times. Saved results go to ``--work`` (a
directory the repository's .gitignore lists).
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
# chip_smoke.py BWD_SHAPES: (B, S, H, hd, causal); the backward is timed at
# the training shape and at head_dim 128.
BWD_SHAPES = [(16, 1024, 12, 64, True), (1, 1000, 12, 64, False),
              (1, 7, 12, 64, True), (2, 512, 8, 128, True)]
BWD_TIMED = [(16, 1024, 12, 64, True), (2, 512, 8, 128, True)]
# chip_smoke.py CE_SHAPES: (N, D, V); the training shape first, timed.
CE_SHAPES = [(16384, 768, 50304), (24, 64, 96), (1000, 768, 50257)]
RING = ("ring_attention_fwd", "ring_attention_bwd")
SPLASH = ("splash_attention_fwd", "splash_attention_bwd")
CE = "fused_ce"
CE_KERNELS = ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")
CE_BWD = "fused_ce bwd"  # the sass key of the CE backward's kernels
RING_TENSORS = ("o", "lse", "dq", "dk", "dv")
GRADS = ("dq", "dk", "dv")

# The resources entry of a splash source that lacks one: the mma.sync
# bodies' kernels (attention_fwd.cuh, attention_bwd.cuh) at the shared size
# they launch with; the backward's dk/dv kernel then its dq kernel.
_PROBES = {
    "splash_attention_fwd": """
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
""",
    "splash_attention_bwd": """
#include "{source}"
template <int HD>
int probe(int* out) {{
  cudaError_t err = kernel_resources(attention_bwd_dkv_kernel<HD, SplashMode>,
                                     kThreads, smem_bytes<HD>(), out);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_resources(attention_bwd_dq_kernel<HD, SplashMode>,
                               kThreads, smem_bytes<HD>(), out + 5);
}}
extern "C" int splash_attention_bwd_resources(int head_dim, int* out) {{
  if (head_dim == 64) return probe<64>(out);
  if (head_dim == 128) return probe<128>(out);
  return (int)cudaErrorInvalidValue;
}}
""",
    # The mma.sync dx and dW kernels, eight warps and bwd_smem_bytes each.
    "fused_ce": """
#include "{source}"
template <int D>
int probe(int* out) {{
  cudaError_t err = kernel_resources(fused_ce_dx_kernel<D>, kThreads,
                                     bwd_smem_bytes<D>(), out);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_resources(fused_ce_dw_kernel<D>, kThreads,
                               bwd_smem_bytes<D>(), out + 5);
}}
extern "C" int fused_ce_resources(int D, int* out) {{
  if (D == 64) return probe<64>(out);
  if (D == 128) return probe<128>(out);
  if (D == 768) return probe<768>(out);
  return (int)cudaErrorInvalidValue;
}}
"""}
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


def _resources(kernel_build, work: Path, label: str) -> dict:
    """What each ring kernel and the splash kernels hold on an SM."""
    import ctypes

    res = {}
    for name in RING:
        fn = _entry(kernel_build.load(name), f"{name}_resources", 3)
        n_kernels = 1 if name.endswith("fwd") else 2
        for hd in (64, 128):
            for first in (0, 1):
                res[f"{name} hd{hd}_first{first}"] = _call(fn, (hd, first),
                                                           n_kernels)
    for name in (*SPLASH, CE):
        lib = kernel_build.load(name)
        if not hasattr(lib, f"{name}_resources"):
            src = work / f"probe_{label}_{name}.cu"
            src.write_text(_PROBES[name].format(
                source=kernel_build.CSRC_DIR / f"{name}.cu"))
            so = work / f"libprobe_{label}_{name}.so"
            out = subprocess.run(
                kernel_build.nvcc_command(kernel_build.find_nvcc(), src, so),
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(
                    f"probe build failed:\n{out.stdout}{out.stderr}")
            lib = ctypes.CDLL(str(so))
        fn = _entry(lib, f"{name}_resources", 2)
        n_kernels = 1 if name.endswith("fwd") else 2
        for width in ((64, 128, 768) if name == CE else (64, 128)):
            key = f"{name} D={width}" if name == CE else f"{name} hd{width}"
            res[key] = _call(fn, (width,), n_kernels)
    lib = kernel_build.load(CE)
    if hasattr(lib, "fused_ce_fwd_resources"):
        fn = _entry(lib, "fused_ce_fwd_resources", 2)
        for width in (64, 128, 768):
            buf = (ctypes.c_int * 7)()
            err = fn(width, ctypes.addressof(buf))
            if err != 0:
                raise RuntimeError(f"fused_ce_fwd_resources({width}): CUDA "
                                   f"error {err}")
            res[f"fused_ce_fwd D={width}"] = dict(zip(
                _FIELDS + ("cluster_size", "active_clusters"), buf))
    return res


def _sass_digest(kernel_build, name: str, function: str = ""):
    """sha256 of a built library's machine code, instruction lines only (the
    names of functions in an unnamed namespace carry the source's path), of
    the functions whose name contains ``function`` (every function by
    default); None where ``cuobjdump`` is missing or fails."""
    import hashlib

    tool = Path(kernel_build.find_nvcc()).with_name("cuobjdump")
    lib = kernel_build.build_dir() / f"lib{name}.so"
    try:
        out = subprocess.run([str(tool), "-sass", str(lib)],
                             capture_output=True, text=True, timeout=120)
    except OSError:
        return None
    if out.returncode != 0:
        return None
    code, keep = [], True
    for line in out.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            keep = function in line
        elif keep and line.startswith("/*"):
            code.append(line)
    return hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]


def worker(tree: Path, label: str, work: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from ray_tpu_torch._private import kernel_build
    from ray_tpu_torch.ops import attention, fused_ce
    from ray_tpu_torch.ops import ring_attention as ra

    if not Path(kernel_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernel_build.__file__}, not {tree}'s")
    import chip_smoke

    kernel_build.build([*RING, *SPLASH, CE])
    for name in (*RING, *SPLASH, CE):
        for line in kernel_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"{label} ptxas {name}: {line.strip()}", flush=True)
    sass = {name: _sass_digest(kernel_build, name) for name in RING}
    # The CE backward's dx and dW kernels, apart from the forward beside them.
    sass[CE_BWD] = _sass_digest(kernel_build, CE, "fused_ce_bwd_kernel")
    print(f"{label} sass " + json.dumps(sass), flush=True)
    (work / f"sass_{label}.json").write_text(json.dumps(sass))
    print(f"{label} resources " + json.dumps(
        _resources(kernel_build, work, label)), flush=True)

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
    gen = torch.Generator(device="cuda").manual_seed(1)
    vs_plain, times = {}, {}
    for B, S, H, hd, causal in BWD_SHAPES:
        qkv = torch.randn((B, S, 3 * H * hd), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        q, k, v = (t.view(B, S, H, hd) for t in qkv.split(H * hd, dim=-1))
        o, lse = attention.splash_attention(q, k, v, causal=causal,
                                            return_lse=True)
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        grads = attention.splash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)
        refs = attention.attention_bwd_reference(q, k, v, o, lse, do,
                                                 causal=causal)
        shape = str((B, S, H, hd, causal))
        vs_plain[shape] = {n: chip_smoke.rel_err(g, r)
                           for n, g, r in zip(GRADS, grads, refs)}
        saved[f"splash_bwd {shape}"] = {n: g.cpu()
                                        for n, g in zip(GRADS, grads)}
        if (B, S, H, hd, causal) in BWD_TIMED:
            times[shape] = chip_smoke.device_ms(
                lambda: attention.splash_attention_bwd(q, k, v, o, lse, do,
                                                       causal=causal))
        del qkv, q, k, v, o, lse, do, grads, refs
    print(f"{label} splash_bwd_vs_plain " + json.dumps(vs_plain), flush=True)
    print(f"{label} splash_bwd_ms " + json.dumps(times), flush=True)
    ce_vs_plain = _ce(fused_ce, chip_smoke, label, saved)
    (work / f"ce_vs_plain_{label}.json").write_text(json.dumps(ce_vs_plain))
    torch.save(saved, work / f"bits_{label}.pt")


def _ce(fused_ce, chip_smoke, label: str, saved: dict) -> dict:
    """The fused CE kernels at CE_SHAPES, made as chip_smoke.py's phase_ce
    makes them: outputs saved, each against its plain version (returned),
    the three kernels' device times at the training shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    vs_plain, times = {}, {}
    for n, (N, D, V) in enumerate(CE_SHAPES):
        x2 = torch.randn((N, D), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        w = (torch.randn((V, D), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        t = torch.randint(0, V, (N,), generator=gen, device="cuda")
        lse, tgt = fused_ce.ce_fwd(x2, w, t)
        dx = fused_ce.ce_dx(x2, w, t, lse)
        dw = fused_ce.ce_dw(x2, w, t, lse)
        shape = str((N, D, V))
        lse_r, tgt_r = fused_ce.ce_fwd_reference(x2, w, t)
        vs_plain[shape] = {
            "lse": (lse - lse_r).abs().max().item(),
            "tgt": (tgt - tgt_r).abs().max().item(),
            "dx": chip_smoke.rel_err(dx, fused_ce.ce_dx_reference(x2, w, t,
                                                                  lse)),
            "dW": chip_smoke.rel_err(dw, fused_ce.ce_dw_reference(x2, w, t,
                                                                  lse))}
        saved[f"ce {shape}"] = {"lse": lse.cpu(), "tgt": tgt.cpu(),
                                "dx": dx.cpu(), "dW": dw.cpu()}
        if n == 0:
            for name, fn in (
                    ("fused_ce_fwd", lambda: fused_ce.ce_fwd(x2, w, t)),
                    ("fused_ce_dx", lambda: fused_ce.ce_dx(x2, w, t, lse)),
                    ("fused_ce_dw", lambda: fused_ce.ce_dw(x2, w, t, lse))):
                times[name] = chip_smoke.device_ms(fn, iters=3)
        del x2, w, t, lse, tgt, dx, dw
        torch.cuda.empty_cache()
    print(f"{label} ce_vs_plain " + json.dumps(vs_plain), flush=True)
    print(f"{label} ce_ms " + json.dumps(times), flush=True)
    return vs_plain


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
        sass = [json.loads((work / f"sass_{t}.json").read_text())
                for t in (base, label)]
        for key, names in (("ring_sass_equal", RING),
                           ("ce_bwd_sass_equal", (CE_BWD,))):
            pair = [[d.get(n) for n in names] for d in sass]
            same = None if None in pair[0] + pair[1] else pair[0] == pair[1]
            print(f"{key} {base} vs {label} {json.dumps(same)}", flush=True)
        ce = {s: per for s, per in diff.items() if s.startswith("ce")}
        plain = [json.loads((work / f"ce_vs_plain_{t}.json").read_text())
                 for t in (base, label)]
        print(f"ce_fwd_diff {base} vs {label} " + json.dumps(
            {s: {n: dict(between=per[n]["max_abs_diff"],
                         **{f"{t}_vs_plain": vp[s[len("ce "):]][n]
                            for t, vp in zip((base, label), plain)})
                 for n in ("lse", "tgt")}
             for s, per in ce.items()}), flush=True)
        print(f"ce_grad_diff {base} vs {label} " + json.dumps(
            {s: {n: per[n]["max_abs_diff"] for n in ("dx", "dW")}
             for s, per in ce.items()}), flush=True)
        finite &= all(d["finite"] for per in diff.values()
                      for d in per.values())
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
