#!/usr/bin/env python3
"""Where one checkpoint save and restore of GPT-2 124M's training state go
(``ray_tpu_torch.checkpoint``), stage by stage, on the card.

    python3 scripts/torch_ckpt_breakdown.py              # on the GPU
    python3 scripts/torch_ckpt_breakdown.py --device cpu --tiny

The state is what ``examples/train_gpt2.py`` reports: ``{"params",
"opt_state", "step"}`` of ``GPTConfig(loss_impl="fused")`` from seed 0,
AdamW's first moment in bf16 (1,244,769,841 bytes at full size). It times
each stage once: the snapshot into a fresh page-locked pool (the
allocation) and into a warm one; one shard's
build; ``leaves.npz`` written and made durable; the same bytes written to
the page cache and then flushed with ``fsync``, apart; the crc32 of the
same bytes in memory (what the zip writer computes for its entries, and
what the manifest's crc32 is built from); the replica payload's own copy;
a whole synchronous save through a ``CheckpointCoordinator`` (persist and
commit); the restore from disk to the host and to the card; and the
restore from in-memory replica payloads to the host and to the card. It
prints one JSON line, with the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ray_tpu_torch.checkpoint import (
        CheckpointCoordinator,
        PinnedPool,
        ShardWriter,
        layout,
        restore_from_payloads,
        restore_pytree,
        snapshot_to_host,
    )
    from ray_tpu_torch.checkpoint import metrics as ckpt_metrics
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.models import gpt2

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_ckpt_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    cfg = train_gpt2.model_config(args.tiny)
    params = gpt2.init_params(cfg, seed=0, device=dev)
    state = {"params": params,
             "opt_state": gpt2.make_optimizer(3e-4).init(params), "step": 0}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    out = {"card": _card() if on_card else "cpu", "device": str(dev)}
    pool = PinnedPool()

    (host, lease), out["snapshot_alloc_s"] = timed(
        lambda: snapshot_to_host(state, pool))
    pool.release(lease)
    (host, lease), out["snapshot_s"] = timed(
        lambda: snapshot_to_host(state, pool))
    (doc, skeleton, kind, arrays), out["build_shard_s"] = timed(
        lambda: layout.build_shard(host, 0, 1))
    root = tempfile.mkdtemp(prefix="torch_ckpt_breakdown_")
    try:
        npz = os.path.join(root, "leaves.npz")
        _, out["write_npz_durable_s"] = timed(
            lambda: layout._write_npz(npz, arrays))
        out["npz_bytes"] = os.path.getsize(npz)
        _, out["entries_crc32_s"] = timed(lambda: [
            zlib.crc32(a.reshape(-1).view(np.uint8)) for a in arrays.values()])
        raw = os.path.join(root, "raw.bin")
        nbytes = sum(a.nbytes for a in arrays.values())
        with open(raw, "wb") as f:
            t0 = time.perf_counter()
            for a in arrays.values():
                f.write(a.reshape(-1).view(np.uint8))
            f.flush()
            out["write_page_cache_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            out["fsync_s"] = time.perf_counter() - t0
        out["raw_bytes"] = nbytes
        payload_arrays, out["replica_copy_s"] = timed(
            lambda: {k: np.array(a) for k, a in arrays.items()})
        payload = {"doc": doc, "skeleton": skeleton, "kind": kind,
                   "arrays": payload_arrays, "shard_id": 0, "step": 0}
        pool.release(lease)
        del host, arrays

        coord = CheckpointCoordinator(os.path.join(root, "ckpt"),
                                      replicate_to_peer=False)
        writer = ShardWriter(coord, replicate=False, pool=pool)

        def commit_sum():
            return sum(v for name, _, v in
                       ckpt_metrics.COMMIT_SECONDS.samples()
                       if name == "_sum")

        c0 = commit_sum()
        _, out["save_sync_s"] = timed(lambda: writer.save_sync(0, state))
        writer.close()
        out["commit_s"] = commit_sum() - c0
        path = layout.final_dir(coord.root, 0)
        _, out["restore_to_host_s"] = timed(lambda: restore_pytree(path))
        _, out["restore_to_device_s"] = timed(
            lambda: restore_pytree(path, device=dev))
        _, out["restore_from_memory_to_host_s"] = timed(
            lambda: restore_from_payloads({0: payload}))
        _, out["restore_from_memory_to_device_s"] = timed(
            lambda: restore_from_payloads({0: payload}, device=dev))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
