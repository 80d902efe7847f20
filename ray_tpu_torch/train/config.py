"""Train configuration dataclasses (the counterpart of
``ray_tpu/train/config.py``; ref: python/ray/air/config.py — ScalingConfig,
RunConfig, FailureConfig, CheckpointConfig; python/ray/train/ re-exports
them)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """(ref: air/config.py ScalingConfig)

    num_workers: size of the worker group.  use_gpu reserves
    ``gpus_per_worker`` of a card per worker (a fraction lets workers share
    one); it is on by default, so ``fit()`` runs on the card unless the
    caller asks for the CPU (``use_gpu=False``), and raises without one.
    On one host the workers are threads sharing the process and its CUDA
    context, and the collective group joins them in-process.
    """

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    #: cards per worker when use_gpu (the reference's tpus_per_worker)
    gpus_per_worker: float = 1.0
    placement_strategy: str = "PACK"
    #: "threads" — workers share this process (one host); "processes" —
    #: each worker is its own OS process joined into one torch.distributed
    #: group, NCCL on its card (ref: backend_executor.py:69 worker actors
    #: across nodes); "auto" — processes iff the placement group's bundles
    #: land on nodes beyond the head, so threads on the one node.
    worker_mode: str = "auto"
    #: The process group's backend for ``worker_mode="processes"``: None
    #: is ``distributed.default_backend()`` (NCCL when a rank holds a card
    #: of its own); "gloo" joins ranks that share one card (NCCL refuses two
    #: ranks on one device), which then stage their collectives through the
    #: host. Never chosen silently.
    backend: Optional[str] = None
    #: Dynamic world size (preemption-tolerant training, thread-tier ranks
    #: only); None = a lost worker restarts the attempt at the same world.
    elastic: Optional["ElasticConfig"] = None

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        res: Dict[str, float] = {"CPU": 1.0}
        if self.use_gpu:
            res = {"GPU": self.gpus_per_worker}
        return res


@dataclass
class ElasticConfig:
    """Preemption-tolerant dynamic world size (thread-tier ranks; the
    Trainer refuses it for ``worker_mode="processes"``, as the reference).

    With ``ScalingConfig(elastic=ElasticConfig(...))`` the Trainer treats
    ``num_workers`` as a *target*, not a contract: on worker/node loss it
    shrinks the collective group and mesh to surviving capacity (never
    below ``min_workers``), elastic-restores the last committed step —
    preferring the in-memory replica tier — reshards the sample ledger so
    every not-yet-trained sample lands on exactly one surviving worker,
    and resumes inside the same ``fit()`` call.  Capacity is re-checked
    every ``grow_check_period_s``; when it supports more workers again the
    group grows back at the next checkpoint boundary (never above
    ``max_workers``, which defaults to ``num_workers``).
    """

    min_workers: int = 1
    max_workers: Optional[int] = None
    grow_check_period_s: float = 2.0

    def resolve_max(self, num_workers: int) -> int:
        return self.max_workers if self.max_workers is not None else num_workers


@dataclass
class DatasetConfig:
    """How the Trainer feeds ``datasets=`` to workers
    (the reference's docs/data-ingestion.md).

    With ``streaming=True`` (the default) every lazy Dataset becomes a
    :class:`~ray_tpu_torch.data.ingest.StreamingIngest`: workers claim source
    shards through a per-epoch ledger and stream them through a
    backpressured executor, a windowed shuffle (O(window) memory, never a
    full-epoch materialization), rebatching and host prefetch —
    ``get_dataset_shard()`` then returns an ``IngestShard``.  With
    ``streaming=False`` the legacy path applies: ``streaming_split`` into
    per-worker ``DataIterator``s (row-balanced, but the whole epoch's
    blocks flow through a central coordinator).
    """

    streaming: bool = True
    #: Shuffle window, in blocks, per worker.  1 disables shuffling beyond
    #: the epoch's shard-order permutation.
    shuffle_window_blocks: int = 16
    #: Epoch shuffles derive from (seed, epoch); None = fresh per process.
    shuffle_seed: Optional[int] = None
    #: Host-side prefetch depth, in batches.  0 disables the pump thread.
    prefetch_batches: int = 2
    #: In-flight byte budget per worker: fetch-ahead + shuffle window.
    window_bytes: int = 128 << 20
    #: Reserved for device double-buffering, which the port's loops ask
    #: for with ``IngestShard.iter_batches(device=...)``.
    device_prefetch: bool = False


@dataclass
class FailureConfig:
    """(ref: air/config.py FailureConfig) max_failures=-1 retries forever."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """(ref: air/config.py CheckpointConfig) top-K retention.

    async_save: ``report(checkpoint=<tree>)`` saves through
    ``ray_tpu_torch.checkpoint`` — each rank's shard snapshotted to
    page-locked host memory on the step, persisted and two-phase-committed
    in the background under ``checkpoints/sharded`` (thread-tier ranks).
    replica_memory_steps: committed steps whose shards stay in the object
    store for restarts to restore from memory.
    """

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    async_save: bool = False
    replica_memory_steps: int = 2


@dataclass
class RunConfig:
    """(ref: air/config.py RunConfig)"""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    #: trial stop criteria, e.g. {"training_iteration": 10} (ref: air
    #: RunConfig.stop)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 0
    #: Tune/experiment callbacks (ref: air RunConfig.callbacks); read by
    #: ``ray_tpu_torch.tune``'s Tuner, which hands them to its controller.
    callbacks: Optional[list] = None
    #: Step-time attribution: every worker gets a StepProfiler that splits
    #: each step's wall time into data-wait / h2d / compute /
    #: collective-sync / checkpoint-block buckets, exports the
    #: ray_tpu_train_* gauges (MFU, tokens/s, step percentiles) and — when
    #: tracing is on — emits train.* spans into the timeline.  Costs a few
    #: timestamps per step; set False to strip even that.
    profile: bool = True
