"""GPT-2 data-parallel training through the Train API: the ``CudaTrainer``
counterpart of ``ray_tpu_torch/bench.py``'s bare loop (and of the
reference's gradient-allreduce loop, ``tests/test_train.py:66-107``).

Each rank builds ``GPTConfig(loss_impl="fused", remat_policy=
"attn_outside")`` on the card its lease names (``granted_cuda_device``),
from seed 0 or from given numpy weights, and per step:
``gpt2.loss_fn``, ``torch.autograd.grad``, ``collective.allreduce`` of the
gradients (their mean over the ranks that had a batch),
``optimizer.update``. It reads
``train.get_dataset_shard("train").iter_batches(batch_size=B,
device=card)`` when the trainer was given a Dataset in
``datasets={"train": ...}`` (a ``tokens`` column of S + 1 ids per row);
under elastic training a sized dataset of S + 1-id rows gives an
``ElasticDatasetShard``, whose batches are the ``(indices, rows)`` the
sample ledger hands out, as the reference's elastic loops read them (a
batch of fewer than B rows at the end). Else rank r takes rows
[r·B, (r+1)·B) of each step's global batch of the ``tokens`` array in its
config. It reports ``{"step", "loss", "tokens", "world"}``, rank 0 with a
checkpoint of ``{"params", "opt_state", "step"}`` every ``ckpt_every``
steps (the ranks' states are equal) — every rank reports the raw tree
under ``async_save`` (``CheckpointConfig(async_save=True)``: each saves
its shard) — and resumes from ``train.get_checkpoint()``.

Run on the card (two thread ranks sharing it):
``python3 -m ray_tpu_torch.examples.train_gpt2``; on the CPU at a tiny
size: ``... --device cpu --tiny``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

#: The Train API's tiny GPT-2: 2 layers, 64 wide, S=32, float32.
TINY = dict(vocab_size=1024, n_layer=2, n_head=4, d_model=64, seq_len=32)


def model_config(tiny: bool = False):
    import torch

    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPTConfig(loss_impl="fused", remat_policy="attn_outside",
                         scan_layers=False)
    if tiny:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  logits_dtype=torch.float32, **TINY)
    return cfg


def _diagnostics(group) -> Dict[str, Any]:
    """Where this rank ran: its process, backend and kernel launches."""
    import torch.distributed as dist

    from ray_tpu_torch.ops import attention, fused_ce

    import ray_tpu_torch

    return {"pid": os.getpid(), "gpu_ids": ray_tpu_torch.get_gpu_ids(),
            "backend": dist.get_backend() if dist.is_initialized()
            else "thread",
            "oversubscribed": getattr(group, "_oversubscribed", False),
            "collective_ops": dict(getattr(group, "ops", {})),
            "launches": {**attention.LAUNCHES, **fused_ce.LAUNCHES},
            "time": time.time()}


def train_loop_per_worker(config: Dict[str, Any]) -> None:
    """One rank's loop. ``config``: ``steps``, ``batch_size`` (per rank),
    ``lr``, ``ckpt_every`` (0: never), ``tiny``, ``device`` ("cpu", else
    the rank's card), ``seed`` or ``init_params`` (a numpy tree),
    ``tokens`` (numpy (N, S + 1), when no dataset is given),
    ``fail_at_step`` (raise there once, in an attempt with nothing to
    restore), ``async_save`` (every rank reports the raw state tree, for
    the trainer's shard writers), ``diagnostics`` (add where it ran to each
    report) and ``probe`` (a callable told of each forward a rank starts,
    given each step's loss, batch rows,
    mean gradients, this rank's own gradients before the all-reduce and
    the updated parameters, the batch, the restored state with the seconds its
    restore took, the checkpointed state, and the seconds a checkpointing
    report took; it runs in the rank, so a process rank's gets a copy)."""
    import torch

    from ray_tpu_torch import collective, train
    from ray_tpu_torch._private.device import granted_cuda_device
    from ray_tpu_torch.models import convert, gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    group = collective.get_collective_group(ctx.collective_group)
    if config.get("device") == "cpu":
        dev = torch.device("cpu")
    else:
        dev = granted_cuda_device()
        torch.cuda.set_device(dev)
    cfg = model_config(config.get("tiny", False))
    S, B = cfg.seq_len, int(config["batch_size"])
    probe = config.get("probe")
    if "init_params" in config:
        params = convert.params_from_numpy(config["init_params"], device=dev)
    else:
        params = gpt2.init_params(cfg, seed=config.get("seed", 0), device=dev)
    optimizer = gpt2.make_optimizer(config.get("lr", 3e-4))
    opt_state = optimizer.init(params)
    step = 0
    restored = train.get_checkpoint()
    if restored is not None:
        t0 = time.perf_counter()
        state = restored.to_pytree({"params": params, "opt_state": opt_state,
                                    "step": 0})
        seconds = time.perf_counter() - t0
        params, opt_state, step = (state["params"], state["opt_state"],
                                   int(state["step"]))
        if probe is not None:
            probe("restore", rank=rank, step=step, state=state,
                  seconds=seconds)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    shard = train.get_dataset_shard("train")
    if isinstance(shard, train.ElasticDatasetShard):
        # Each claim is tagged with the step it trains, so that a restore
        # rolls back exactly the rows of the steps it undoes.
        batches = (torch.as_tensor(np.asarray(rows), device=dev)
                   for _, rows in shard.iter_batches(B))
    elif shard is not None:
        batches = (b["tokens"] for b in shard.iter_batches(batch_size=B,
                                                          device=dev))
    else:
        tokens = np.asarray(config["tokens"])

        def rank_rows():
            i = step
            while True:
                rows = (np.arange(B * world) + i * B * world) % len(tokens)
                yield torch.as_tensor(tokens[rows[rank * B:(rank + 1) * B]],
                                      device=dev)
                i += 1

        batches = rank_rows()

    steps = int(config.get("steps", 0)) or None
    ckpt_every = int(config.get("ckpt_every", 0))
    n_params = sum(p.numel() for p in leaves)
    batches = iter(batches)
    while steps is None or step < steps:
        if step == config.get("fail_at_step") and restored is None:
            raise RuntimeError(f"failure injected at step {step}")
        tok = next(batches, None)
        # The flat gradient carries the count of ranks that had a batch:
        # ranks whose shard ran out first send zeros and keep stepping with
        # the others (their parameters stay equal), until every shard is
        # done. Streaming ingest hands shards out as ranks ask, so their
        # counts differ.
        if tok is not None:
            if probe is not None:
                probe("forward", rank=rank, step=step + 1)
            loss = gpt2.loss_fn(params, tok[:, :S], tok[:, 1:], cfg)
            grads = torch.autograd.grad(loss, leaves)
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [torch.ones(1, device=dev)])
        else:
            flat = torch.zeros(n_params + 1, device=dev)
        flat = collective.allreduce(flat, group_name=ctx.collective_group)
        ranks_with_data = float(flat[-1])
        if ranks_with_data == 0:
            break
        flat = flat[:-1].div_(ranks_with_data)
        it = iter(flat.split([p.numel() for p in leaves]))
        grad_tree = tree_map(lambda p: next(it).view(p.shape), params)
        opt_state = optimizer.update(grad_tree, opt_state, params)
        step += 1
        if tok is None:
            continue
        metrics = {"step": step, "loss": float(loss.detach()),
                   "tokens": tok.shape[0] * S, "world": world}
        if probe is not None:
            it = iter(grads)
            probe("step", rank=rank, step=step, loss=metrics["loss"],
                  rows=tok.shape[0], tokens=tok, grads=grad_tree,
                  local_grads=tree_map(lambda _: next(it), params),
                  params=params)
        checkpoint = None
        saving = ckpt_every and step % ckpt_every == 0
        if saving and (rank == 0 or config.get("async_save")):
            state = {"params": params, "opt_state": opt_state, "step": step}
            if probe is not None:
                probe("checkpoint", rank=rank, step=step, state=state)
            checkpoint = state
            if not config.get("async_save"):
                t0 = time.perf_counter()
                checkpoint = train.Checkpoint.from_pytree(state)
                metrics["save_ms"] = (time.perf_counter() - t0) * 1e3
                metrics["ckpt_bytes"] = sum(
                    os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(checkpoint.path)
                    for f in files)
        if config.get("diagnostics"):
            metrics.update(_diagnostics(group), device=str(dev))
        t0 = time.perf_counter()
        train.report(metrics, checkpoint=checkpoint)
        if checkpoint is not None and probe is not None:
            probe("saved", rank=rank, step=step,
                  seconds=time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=8, help="rows per rank")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the host (no card is leased)")
    parser.add_argument("--tiny", action="store_true",
                        help="a 2-layer, 64-wide GPT-2 at S=32, float32")
    args = parser.parse_args(argv)

    import ray_tpu_torch
    from ray_tpu_torch.train import CudaTrainer, ScalingConfig

    on_cpu = args.device == "cpu"
    cfg = model_config(args.tiny)
    tokens = np.random.default_rng(0).integers(
        0, min(cfg.vocab_size, 50257), (args.workers * args.batch,
                                        cfg.seq_len + 1), dtype=np.int64)

    def log_step(event, rank, step, **info):
        """One line per step of rank 0 (a job's log follows the run)."""
        if event == "step" and rank == 0:
            print(f"train_gpt2 step {step} loss {info['loss']:.6f}",
                  flush=True)

    ray_tpu_torch.init(ignore_reinit_error=True,
                       **({"num_gpus": 0} if on_cpu else {}))
    try:
        t0 = time.perf_counter()
        result = CudaTrainer(
            train_loop_per_worker,
            train_loop_config=dict(steps=args.steps, batch_size=args.batch,
                                   tiny=args.tiny, device=args.device,
                                   tokens=tokens, probe=log_step),
            scaling_config=ScalingConfig(
                num_workers=args.workers, use_gpu=not on_cpu,
                gpus_per_worker=1.0 / args.workers)).fit()
        dt = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    losses = [m["loss"] for m in result.metrics_history]
    ok = result.error is None and len(losses) == args.steps and \
        bool(np.isfinite(losses).all())
    print(f"train_gpt2 workers={args.workers} steps={len(losses)} "
          f"losses={[round(x, 4) for x in losses]} elapsed={dt:.2f}s "
          f"{'OK' if ok else f'FAILED {result.error!r}'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
