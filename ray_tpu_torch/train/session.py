"""Per-worker train session: the report() channel and worker context (the
counterpart of ``ray_tpu/train/session.py``).

(ref: python/ray/train/_internal/session.py — _TrainSession:112, report
:405/:672: a queue between the user's training thread and the controller).
A thread-tier worker IS a thread in the controller's process, so the
session is a thread-local object with a plain queue the controller drains;
process-tier workers get a session that reports through an actor queue
(``trainer.DistTrainSession``, ``torch_trainer.ProcessTrainSession``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train import profiler as _profiler
from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


class TrainContext:
    """What the user's train_loop sees via get_context()
    (ref: train/context.py TrainContext)."""

    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 node_rank: int = 0, trial_name: str = "",
                 experiment_name: str = "", group_name: str = "train"):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.trial_name = trial_name
        self.experiment_name = experiment_name
        self.collective_group = group_name

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_experiment_name(self) -> str:
        return self.experiment_name


class TrainSession:
    def __init__(self, context: TrainContext,
                 checkpoint_to_restore: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 shard_writer=None, start_step: int = 0,
                 dataset_config=None, profiler=None):
        self.context = context
        self.results: "queue.Queue" = queue.Queue()
        self.checkpoint_to_restore = checkpoint_to_restore
        self.dataset_shards = dataset_shards or {}
        #: the Trainer's DatasetConfig — user loops read it through
        #: train.get_dataset_config() for prefetch/shuffle tuning knobs.
        self.dataset_config = dataset_config
        self.stop_requested = threading.Event()
        #: ray_tpu_torch.checkpoint.ShardWriter when async checkpointing is
        #: on (CheckpointConfig.async_save) — report(checkpoint=<tree>) then
        #: goes through the coordinator's two-phase commit instead of the
        #: in-band queue, blocking only for the device->host snapshot.
        self.shard_writer = shard_writer
        #: next coordinator step id; starts past the latest committed step
        #: so a resumed attempt never collides with history (streaming
        #: ingest tags this session's shard claims with it).
        self._ckpt_step = start_step
        #: how many async saves this session handed to the shard writer,
        #: and the newest SaveHandle — the trainer checks these after the
        #: run so an every-save-failed run cannot finish silently with no
        #: checkpoint and no error.
        self.async_saves_reported = 0
        self.last_save_handle = None
        #: the StepProfiler when step profiling is on (RunConfig.profile,
        #: the default) — activated on the worker thread with the session
        #: itself; report() is its step boundary.
        self.profiler = profiler
        #: set by the controller when this rank's actor died (killed, or
        #: its node preempted): the thread runs on until a boundary, and
        #: what it reports is dropped.
        self.fenced = False

    def fence(self) -> None:
        """Drop this rank's reports from now on, and stop it at the next."""
        self.fenced = True
        self.stop_requested.set()

    def current_checkpoint_step(self) -> int:
        """The checkpoint step the next report() saves as — the step being
        trained. The elastic sample ledger tags claims with it, so that a
        restore knows exactly which claims roll back."""
        return self._ckpt_step

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Any] = None) -> None:
        # Chaos: the per-step worker-crash point (also consulted at run()
        # entry by TrainWorker).
        from ray_tpu_torch._private import fault_injection

        if self.fenced:
            raise StopIteration("this rank's actor died; its report is dropped")
        fault_injection.check("train_worker_run")
        if checkpoint is not None and not isinstance(checkpoint, Checkpoint):
            # A raw tree: async sharded save when wired, else wrap it in a
            # directory checkpoint.
            if self.shard_writer is not None:
                step = self._ckpt_step
                self._ckpt_step += 1
                self.last_save_handle = self.shard_writer.save_async(
                    step, checkpoint)
                self.async_saves_reported += 1
                checkpoint = None
            else:
                checkpoint = Checkpoint.from_pytree(checkpoint)
        self.results.put({"metrics": metrics, "checkpoint": checkpoint,
                          "rank": self.context.world_rank})
        # report() IS the step boundary: close the profiled step (spans +
        # live gauges) now that its checkpoint-block time is recorded.
        if self.profiler is not None:
            self.profiler.step_boundary()
        if self.stop_requested.is_set():
            raise StopIteration("Training stopped by the controller")


def init_session(session) -> None:
    _local.session = session
    _profiler.activate(getattr(session, "profiler", None))


def clear_session() -> None:
    _local.session = None
    _profiler.activate(None)


def get_session():
    return getattr(_local, "session", None)


def _require_session():
    s = get_session()
    if s is None:
        raise RuntimeError(
            "No train session active — this API must be called inside a "
            "train_loop launched by a Trainer.")
    return s


# ------------------------- public functional API (ref: ray.train.*) ---------

def report(metrics: Dict[str, Any], checkpoint: Optional[Any] = None) -> None:
    """(ref: session.py report:672) — ``checkpoint`` is a Checkpoint or a
    tree to save as one."""
    _require_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return _require_session().context


def get_checkpoint() -> Optional[Checkpoint]:
    """Checkpoint to resume from after a restart (ref: train.get_checkpoint)."""
    return _require_session().checkpoint_to_restore


def get_dataset_shard(name: str = "train"):
    """(ref: train.get_dataset_shard) — the worker's split of a Dataset."""
    return _require_session().dataset_shards.get(name)


def get_dataset_config():
    """The Trainer's :class:`~ray_tpu_torch.train.DatasetConfig` (or None
    when the run was launched without one)."""
    return getattr(_require_session(), "dataset_config", None)
