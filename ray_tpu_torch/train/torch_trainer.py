"""TorchTrainer — distributed data-parallel PyTorch on process-tier workers
(the counterpart of ``ray_tpu/train/torch_trainer.py``).

(ref: python/ray/train/torch/torch_trainer.py:11 TorchTrainer +
train/torch/config.py:66,115,153 _TorchBackend/_setup_torch_process_group —
each Ray Train worker actor joins a torch.distributed process group; the
user loop wraps its model with DDP via prepare_model.)

Workers are process-tier actors (torch.distributed wants one process per
rank) that rendezvous over a TCP store: NCCL when the rank holds a card,
gloo otherwise. Results flow back through an actor-backed report queue (the
thread tier's in-memory TrainSession cannot cross a process boundary). As
in the reference, ``datasets=`` and ``ScalingConfig.elastic`` are refused:
``CudaTrainer`` takes both. So is ``CheckpointConfig(async_save=True)``:
the port's shard writers run in thread ranks (``CudaTrainer``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.session import TrainContext, clear_session, init_session
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    _drive_worker_refs,
    _Drain,
    _reserve_addr,
    invoke_train_loop,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


class ProcessTrainSession:
    """Pickle-safe session for process-tier workers: report() ships
    (metrics, checkpoint path) through an actor-backed queue instead of the
    thread tier's shared in-memory queue (ref: _TrainSession:112 — same
    contract, different transport). The path names this host's disk: the
    ranks share the controller's node."""

    def __init__(self, context: TrainContext, report_queue,
                 checkpoint_to_restore: Optional[Checkpoint] = None):
        self.context = context
        self._queue = report_queue
        self.checkpoint_to_restore = checkpoint_to_restore
        self.dataset_shards: Dict[str, Any] = {}

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Any] = None) -> None:
        if checkpoint is not None and not isinstance(checkpoint, Checkpoint):
            checkpoint = Checkpoint.from_pytree(checkpoint)
        self._queue.put({
            "rank": self.context.world_rank,
            "metrics": dict(metrics),
            "checkpoint_path": checkpoint.path if checkpoint else None,
        })

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint_to_restore

    def get_dataset_shard(self, name: str):
        raise ValueError(
            "dataset shards are not available on process-tier torch workers "
            "(streaming iterators cannot cross the process boundary); load "
            "data inside the train_loop or use CudaTrainer")


@ray_tpu_torch.remote
class TorchTrainWorker:
    """One torch.distributed rank in its own OS process
    (ref: _internal/worker_group.py:19 RayTrainWorker + torch backend
    on_start).  Always created with isolation='process'."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

    def reserve_master(self) -> str:
        """Rank 0 picks the rendezvous address (ref: torch/config.py:66)."""
        return _reserve_addr()

    def setup(self, master: str) -> str:
        """Join the process group: NCCL on the rank's card, gloo without
        one. Returns the backend."""
        from ray_tpu_torch.collective import distributed

        return distributed.initialize(master, self.world_size, self.rank)

    def run(self, train_loop: Callable, loop_config: Optional[Dict[str, Any]],
            session: ProcessTrainSession) -> str:
        init_session(session)
        try:
            invoke_train_loop(train_loop, loop_config)
            return "done"
        finally:
            clear_session()

    def shutdown_group(self) -> None:
        from ray_tpu_torch.collective import distributed

        distributed.shutdown()


def prepare_model(model):
    """Wrap the model for data-parallel training
    (ref: train/torch/train_loop_utils.py prepare_model — DDP)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    if dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedDataParallel(model)
    return model


class TorchTrainer(DataParallelTrainer):
    """Same controller contract as DataParallelTrainer (restarts, checkpoint
    manager, PG gang scheduling) with the worker group swapped for
    process-tier torch ranks."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.datasets:
            # Constructor-time invariant: fail before any placement-group
            # reservation is paid for a run that can never proceed.
            raise ValueError(
                "TorchTrainer does not support datasets= (process workers "
                "cannot receive streaming iterators); load data inside the "
                "train_loop or use CudaTrainer")
        if self.run_config.checkpoint_config.async_save:
            raise ValueError(
                "TorchTrainer does not support CheckpointConfig(async_save="
                "True) (a process rank's shard writer is not ported: "
                "ROADMAP.md, Queue 1 item 6); use CudaTrainer")

    def _run_with_pg(self, pg, run_name: str, group_name: str,
                     manager: CheckpointManager, restore_ckpt,
                     ingests=None, coordinator=None, world=None,
                     ledgers=None) -> Dict:
        # The elastic world, ledgers and ingests are the thread tier's: no
        # datasets= here, and ScalingConfig.elastic is refused.
        import time

        from ray_tpu_torch.exceptions import RayTpuError, TaskError
        from ray_tpu_torch.util.queue import Empty, Queue

        scfg = self.scaling_config
        if scfg.elastic is not None:
            return {"status": "fatal", "last_metrics": None, "history": [],
                    "error": ValueError(
                        "elastic training requires thread-tier workers; "
                        "TorchTrainer ranks are process-tier (use "
                        "CudaTrainer with ScalingConfig(worker_mode="
                        "'threads'))")}
        world = scfg.num_workers
        report_queue = Queue()
        workers = []
        sessions: List[ProcessTrainSession] = []
        for rank in range(world):
            ctx = TrainContext(world_rank=rank, world_size=world,
                               local_rank=rank, trial_name=run_name,
                               experiment_name=run_name,
                               group_name=group_name)
            sessions.append(ProcessTrainSession(ctx, report_queue,
                                                restore_ckpt))
            workers.append(
                TorchTrainWorker.options(
                    isolation="process",
                    resources=scfg.worker_resources(),
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg,
                        placement_group_bundle_index=rank),
                ).remote(rank, world))

        drained = _Drain(manager)

        def drain() -> None:
            while True:
                try:
                    item = report_queue.get_nowait()
                except Empty:
                    return
                path = item["checkpoint_path"]
                drained.item(item["rank"], item["metrics"],
                             Checkpoint(path) if path else None)

        try:
            master = ray_tpu_torch.get(workers[0].reserve_master.remote(),
                                       timeout=120)
            ray_tpu_torch.get([w.setup.remote(master) for w in workers],
                              timeout=180)
            refs = [w.run.remote(self.train_loop, self.train_loop_config, s)
                    for w, s in zip(workers, sessions)]
            _drive_worker_refs(refs, drain)
            for w in workers:
                try:
                    ray_tpu_torch.get(w.shutdown_group.remote(), timeout=10)
                except (TaskError, RayTpuError):
                    pass  # the process is discarded below either way
            return drained.outcome("finished")
        except (TaskError, RayTpuError) as e:
            failed_at = time.monotonic()
            drain()
            return drained.outcome("failed", error=e, failed_at=failed_at)
        finally:
            for w in workers:
                ray_tpu_torch.kill(w)
            report_queue.shutdown()
