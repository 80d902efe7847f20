"""Trainers and the training controller (the counterpart of
``ray_tpu/train/trainer.py``).

Modeled on the reference's Train v2 architecture (ref: python/ray/train/v2/
_internal/execution/controller.py:73 TrainController — a standalone control
loop polling a WorkerGroup, with a FailurePolicy). Workers are actors (ref:
_internal/worker_group.py:102 WorkerGroup, RayTrainWorker:19), gang-
scheduled through a placement group whose bundles name their cards. On one
node they are thread actors sharing this process and its CUDA context, and
the loop syncs gradients through ``ray_tpu_torch.collective`` (the thread
tier); with ``ScalingConfig(worker_mode="processes")`` each worker is its
own process, joined into one ``torch.distributed`` group, NCCL on its card
(``CudaDistTrainWorker``).

Recovery (ref: v2 FailurePolicy): a worker failure tears down the group,
and the whole group restarts from the newest registered checkpoint —
delivered to workers via ``train.get_checkpoint()`` — up to
``FailureConfig.max_failures`` times.

Async checkpoints (``CheckpointConfig(async_save=True)``, thread-tier
ranks): a ``CheckpointCoordinator`` actor on the head owns
``checkpoints/sharded``, each rank gets a ``ShardWriter`` per attempt, and
``report(checkpoint=<tree>)`` blocks only for the device->host snapshot; a
restart restores the coordinator's newest committed step, from its
in-memory replicas when they are whole, then the peer holder's copies,
else from the committed directory.

Elastic training (``ScalingConfig(elastic=ElasticConfig(...))``,
thread-tier ranks): the world size is dynamic. A lost rank or node shrinks
the group to what the live cluster can host (``autoscaler/elastic.py``),
restores the last committed step — memory replicas first — rolls the
exactly-once sample ledgers back (``train/elastic.py``) and resumes inside
the same ``fit()``; when capacity comes back the group grows again at the
next checkpoint boundary. Ranks reach a failed attempt's stop at their next
boundary (a report, a collective, a ledger claim); what they reported
before is kept, and what a rank whose actor died reports after is dropped.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import collective
from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.exceptions import RayTpuError, TaskError
from ray_tpu_torch.train import metrics as train_metrics
from ray_tpu_torch.train import run_registry
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    pack_checkpoint,
    unpack_checkpoint,
)
from ray_tpu_torch.train.config import DatasetConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.elastic import ElasticDatasetShard, SampleLedger
from ray_tpu_torch.train.profiler import StepProfiler
from ray_tpu_torch.train.session import (
    TrainContext,
    TrainSession,
    clear_session,
    init_session,
)
from ray_tpu_torch.util import flight_recorder, tracing
from ray_tpu_torch.util.placement_group import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)

#: Seconds a gang reservation may wait for its placement group.
PG_WAIT_S = 60.0
#: Seconds an attempt's end waits for each rank's async saves to land.
SAVE_DRAIN_S = 120.0
#: Seconds a failed attempt waits for its ranks to reach their stop.
RANK_STOP_S = 30.0


def _drop_frames(err: BaseException) -> BaseException:
    """``err`` without its frames: a rank's error holds the frames of its
    loop, and they its tensors (on the card, its whole state). The message
    and the formatted remote traceback stay."""
    seen, todo = set(), [err]
    while todo:
        x = todo.pop()
        if not isinstance(x, BaseException) or id(x) in seen:
            continue
        seen.add(id(x))
        x.__traceback__ = None
        todo += [getattr(x, "cause", None), x.__cause__, x.__context__]
    return err


def _settle(writers) -> None:
    """Wait (bounded) for each shard writer's persists, then close it."""
    import logging

    for wtr in writers:
        try:
            wtr.drain(timeout=SAVE_DRAIN_S)
        except TimeoutError:
            logging.getLogger(__name__).warning(
                "shard %s: async saves still persisting after %.0f s",
                wtr.shard_id, SAVE_DRAIN_S)
        wtr.close()


class Result:
    """(ref: python/ray/train/result.py Result)"""

    def __init__(self, metrics: Optional[Dict[str, Any]], checkpoint: Optional[Checkpoint],
                 path: str, error: Optional[BaseException] = None,
                 metrics_history: Optional[List[Dict[str, Any]]] = None,
                 restarts: Optional[List[Dict[str, Any]]] = None,
                 elastic_events: Optional[List[Dict[str, Any]]] = None):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.path = path
        self.error = error
        self.metrics_history = metrics_history or []
        #: One record per failed attempt the run restarted from: the
        #: attempt, its error, ``resumed_s`` — seconds from the failure
        #: to the first report of the next attempt (None if none came) —
        #: and, under async saves, ``restore``: the coordinator step the
        #: restart restored, its ``source`` ("memory" or "disk") and the
        #: ``seconds`` that took (None: no committed step).
        self.restarts = restarts or []
        #: shrink/recover/grow records of elastic training (empty unless
        #: ScalingConfig.elastic): type, from_world/to_world, restore_step,
        #: lost_steps, requeued_samples, recovery_seconds.
        self.elastic_events = elastic_events or []

    def __repr__(self) -> str:
        return f"Result(metrics={self.metrics}, checkpoint={self.checkpoint}, error={self.error})"


def invoke_train_loop(train_loop: Callable,
                      loop_config: Optional[Dict[str, Any]]) -> None:
    """Signature-dispatch shared by every worker kind (ref: the reference
    accepts both `def loop()` and `def loop(config)`)."""
    import inspect

    sig = inspect.signature(train_loop)
    if len(sig.parameters) >= 1:
        train_loop(loop_config or {})
    else:
        train_loop()


@ray_tpu_torch.remote
class TrainWorker:
    """A thread-tier rank (ref: _internal/worker_group.py:19 RayTrainWorker)."""

    def __init__(self, rank: int, world_size: int, group_name: str):
        self.rank = rank
        self.world_size = world_size
        # A process launched into a torch.distributed group by its operator
        # (RAY_TPU_COORDINATOR/...) joins it first (ref:
        # train/torch/config.py:66 _setup_torch_process_group).
        from ray_tpu_torch.collective import distributed

        distributed.auto_initialize()
        collective.init_collective_group(world_size, rank,
                                         group_name=group_name)

    def run(self, train_loop: Callable, loop_config: Optional[Dict[str, Any]],
            session: TrainSession) -> str:
        # Chaos: a worker dying right at run entry (the other half of the
        # per-report() consultation in TrainSession.report).
        fault_injection.check("train_worker_run")
        init_session(session)
        try:
            invoke_train_loop(train_loop, loop_config)
            return "done"
        except StopIteration:
            return "stopped"
        finally:
            clear_session()


def _reserve_addr() -> str:
    """A free port on this host as "127.0.0.1:port": the rendezvous address
    rank 0 advertises. The runtime has one node, so the loopback address
    reaches every rank. TOCTOU-racy by nature; the rendezvous is bounded
    (``distributed.INIT_TIMEOUT_S``) for exactly that reason."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _drive_worker_refs(refs, drain) -> None:
    """Poll a worker group's run() refs to completion, draining the report
    channel as results stream in; re-raises the first worker error (shared
    by the process-tier controllers)."""
    pending = list(refs)
    while pending:
        ready, pending = ray_tpu_torch.wait(pending, num_returns=len(pending),
                                            timeout=0.05)
        drain()
        for r in ready:
            ray_tpu_torch.get(r)  # raise worker errors here
    drain()


class DistTrainSession:
    """Pickle-safe session for process-tier workers: report() ships metrics
    and the checkpoint directory BY VALUE (a tar) through an actor-backed
    queue (ref: _TrainSession:112 contract; train/_internal/storage.py
    checkpoint upload)."""

    def __init__(self, context: TrainContext, report_queue,
                 checkpoint_to_restore: Optional[Checkpoint] = None):
        self.context = context
        self._queue = report_queue
        self.checkpoint_to_restore = checkpoint_to_restore
        self.dataset_shards: Dict[str, Any] = {}
        self.stop_requested = threading.Event()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Any] = None) -> None:
        if checkpoint is not None and not isinstance(checkpoint, Checkpoint):
            checkpoint = Checkpoint.from_pytree(checkpoint)
        try:
            self._queue.put({
                "rank": self.context.world_rank,
                "metrics": dict(metrics),
                "checkpoint_blob": pack_checkpoint(checkpoint),
            })
        finally:
            if checkpoint is not None:
                # Shipped by value: the local copy is this worker's scratch.
                shutil.rmtree(checkpoint.path, ignore_errors=True)


@ray_tpu_torch.remote
class CudaDistTrainWorker:
    """One torch.distributed rank in its own OS process: the counterpart of
    ``JaxDistTrainWorker`` (ref: _internal/backend_executor.py:69 — the
    worker group's actors bootstrapped into one process group;
    train/torch/config.py:66,115 _setup_torch_process_group).

    The process sees only its lease's cards; ``setup`` selects the granted
    one and joins the group through rank 0's reserved address, NCCL on the
    card (gloo for a rank without one). ``ray_tpu_torch.collective`` ops
    then run as process-group calls (collective/process_group.py). Always
    created with isolation='process'."""

    def __init__(self, rank: int, world_size: int, group_name: str):
        self.rank = rank
        self.world = world_size
        self.group_name = group_name

    def reserve_coordinator(self) -> str:
        """Rank 0 picks the process group's rendezvous address."""
        return _reserve_addr()

    def setup(self, coordinator: str, backend: Optional[str] = None
              ) -> Dict[str, Any]:
        """Join the process group over ``backend`` (None: the default, NCCL
        on the card); returns the topology for checks, with when the
        worker's main loop started and when this call entered and joined
        (``time.time()``). Called CONCURRENTLY on all ranks (initialization
        is a barrier)."""
        from ray_tpu_torch._private import process_pool
        from ray_tpu_torch.collective import distributed

        entered = time.time()
        backend = distributed.initialize(coordinator, self.world, self.rank,
                                         backend=backend)
        collective.init_collective_group(self.world, self.rank,
                                         group_name=self.group_name)
        return {"rank": self.rank, "backend": backend, "pid": os.getpid(),
                "process_count": distributed.process_count(),
                "worker_main_at": process_pool.WORKER_MAIN_AT,
                "setup_at": entered, "joined_at": time.time()}

    def run(self, train_loop: Callable, loop_config: Optional[Dict[str, Any]],
            context: TrainContext, report_queue,
            restore_blob: Optional[bytes]) -> str:
        restore = unpack_checkpoint(restore_blob)
        session = DistTrainSession(context, report_queue, restore)
        init_session(session)
        try:
            invoke_train_loop(train_loop, loop_config)
            return "done"
        finally:
            clear_session()
            if restore is not None:
                # The unpacked restore dir is this attempt's scratch copy.
                shutil.rmtree(restore.path, ignore_errors=True)

    def teardown(self) -> None:
        collective.destroy_collective_group(self.group_name)
        from ray_tpu_torch.collective import distributed

        distributed.shutdown()


class DataParallelTrainer:
    """(ref: python/ray/train/data_parallel_trainer.py:25)"""

    _collective_counter = 0

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dataset_config: Optional[DatasetConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.dataset_config = dataset_config or DatasetConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        #: One dict per named dataset on the streaming path (tests audit
        #: per-shard exactly-once accounting after fit() returns).
        self.streaming_ingests: Dict[str, Any] = {}
        #: The elastic path's exactly-once ledgers, one per sized dataset
        #: (tests audit them after fit() returns).
        self.sample_ledgers: Dict[str, SampleLedger] = {}
        # Elastic recovery clock: set at a shrink or grow, closed by the
        # first report of the resumed attempt (failure -> resumed).
        self._recovery_t0: Optional[float] = None
        self._recovery_event: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ fit
    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        scfg = self.scaling_config
        elastic = scfg.elastic
        if scfg.use_gpu and scfg.resources_per_worker is None:
            have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if have < scfg.gpus_per_worker:
                raise RuntimeError(
                    f"ScalingConfig(use_gpu=True) needs a card, and the "
                    f"cluster has {have} GPUs (torch finds no CUDA device?); "
                    f"pass use_gpu=False to train on the CPU")
        run_name = self.run_config.name or f"train_{int(time.time())}"
        storage = self.run_config.storage_path or tempfile.mkdtemp(
            prefix="ray_tpu_torch_train_")
        experiment_path = os.path.join(storage, run_name)
        ckpt_conf = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(experiment_path, "checkpoints"),
            num_to_keep=ckpt_conf.num_to_keep,
            score_attribute=ckpt_conf.checkpoint_score_attribute,
            score_order=ckpt_conf.checkpoint_score_order,
        )
        # The most ranks an attempt can have.
        max_world = (max(scfg.num_workers, elastic.resolve_max(scfg.num_workers))
                     if elastic is not None else scfg.num_workers)
        # Async checkpointing (CheckpointConfig.async_save): a
        # CheckpointCoordinator actor owns its own subdirectory (it and the
        # CheckpointManager number checkpoint_NNNNNN dirs from independent
        # counters) and two-phase-commits the sharded saves flowing out of
        # report(checkpoint=<tree>); restarts restore from its latest
        # committed step. It is pinned to the head, where this controller
        # runs: a preempted worker node must never take the commit
        # authority with it (elastic recovery asks it what to restore).
        coordinator = None
        #: each rank's page-locked snapshot buffers, for every attempt
        self._snapshot_pools: List[Any] = []
        if ckpt_conf.async_save:
            from ray_tpu_torch._private.runtime import get_runtime
            from ray_tpu_torch.checkpoint import (
                CheckpointCoordinator,
                PinnedPool,
            )
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeAffinitySchedulingStrategy,
            )

            coordinator = ray_tpu_torch.remote(CheckpointCoordinator).options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    str(get_runtime().head_node_id), soft=True),
            ).remote(
                os.path.join(experiment_path, "checkpoints", "sharded"),
                keep=ckpt_conf.num_to_keep,
                replica_steps=ckpt_conf.replica_memory_steps)
            self._snapshot_pools = [PinnedPool() for _ in range(max_world)]
        cur_world = scfg.num_workers
        elastic_events: List[Dict[str, Any]] = []
        # The run is visible to /api/train_runs for its whole lifetime.
        run_registry.register_run(run_name, world_size=cur_world,
                                  target_world=cur_world,
                                  path=experiment_path,
                                  elastic=elastic is not None)
        self._recovery_t0 = None
        self._recovery_event = None
        # Elastic data plane: every sized dataset becomes a shared
        # exactly-once ledger that outlives the attempts (exclusive
        # claiming IS the reshard; train/elastic.py).
        ledgers: Dict[str, SampleLedger] = {}
        if elastic is not None:
            for name, ds in self.datasets.items():
                if (not hasattr(ds, "streaming_split")
                        and hasattr(ds, "__len__")
                        and hasattr(ds, "__getitem__")):
                    ledgers[name] = SampleLedger(
                        ds, seal_on_claim=coordinator is None)
        self.sample_ledgers = ledgers
        # Streaming data plane: with DatasetConfig(streaming=True) — the
        # default — every lazy Dataset becomes a StreamingIngest shared
        # across attempts: workers claim source shards through a per-epoch
        # ledger (claiming IS the resplit when the world changes) and
        # stream them through backpressure -> windowed shuffle -> rebatch
        # -> prefetch. Other datasets take the legacy split.
        dcfg = self.dataset_config
        ingests: Dict[str, Any] = {}
        if dcfg.streaming:
            from ray_tpu_torch.data.ingest import StreamingIngest

            for name, ds in self.datasets.items():
                if name not in ledgers and hasattr(ds, "_op"):
                    ingests[name] = StreamingIngest(
                        ds,
                        window_blocks=dcfg.shuffle_window_blocks,
                        window_bytes=dcfg.window_bytes,
                        seed=dcfg.shuffle_seed,
                        prefetch_batches=dcfg.prefetch_batches,
                        seal_on_claim=coordinator is None)
        self.streaming_ingests = ingests

        max_failures = self.run_config.failure_config.max_failures
        failures = 0
        attempt_no = 1
        restore_ckpt = self.resume_from_checkpoint
        last_restore_step: Optional[int] = None
        history: List[Dict[str, Any]] = []
        restarts: List[Dict[str, Any]] = []

        def result(outcome: Dict, error: Optional[BaseException]) -> Result:
            return Result(metrics=outcome["last_metrics"],
                          checkpoint=(manager.latest_checkpoint()
                                      or self._coordinator_checkpoint(
                                          coordinator, from_memory=False)),
                          path=experiment_path, error=error,
                          metrics_history=history, restarts=restarts,
                          elastic_events=elastic_events)

        try:
            while True:
                outcome = self._run_attempt(run_name, manager, restore_ckpt,
                                            ingests, coordinator,
                                            world=cur_world, ledgers=ledgers)
                history.extend(outcome["history"])
                if restarts and restarts[-1]["resumed_s"] is None:
                    first = outcome.get("first_report_at")
                    if first is not None:
                        restarts[-1]["resumed_s"] = \
                            first - restarts[-1]["failed_at"]
                if outcome["status"] == "finished":
                    run_registry.finish_run(run_name, "finished")
                    for ledger in ledgers.values():
                        ledger.seal_all()  # clean finish: nothing rolls back
                    for ingest in ingests.values():
                        # Claims the prefetch pump made but whose batches
                        # the loop never consumed roll back, so audit()
                        # never reports them trained.
                        ingest.finish()
                    # Surfaces e.g. "every async save failed": training
                    # succeeded but the run has no usable checkpoint.
                    return result(outcome, outcome["error"])
                if outcome["status"] == "grow":
                    # Capacity came back and every rank stopped at a
                    # checkpoint boundary: restore the committed step (its
                    # save drained before we got here) and run the next
                    # attempt at the bigger world. Not a failure.
                    new_world = outcome["new_world"]
                    restore_ckpt, step = self._elastic_restore_point(
                        coordinator, manager)
                    for ledger in ledgers.values():
                        ledger.rollback(step)
                    for ingest in ingests.values():
                        ingest.rollback(step)
                    train_metrics.GROW_EVENTS.inc()
                    event = {"type": "grow", "from_world": cur_world,
                             "to_world": new_world, "restore_step": step,
                             "time": time.time()}
                    self._elastic_event(run_name, elastic_events, event,
                                        time.monotonic())
                    cur_world = new_world
                    attempt_no += 1
                    run_registry.update_run(run_name, attempts=attempt_no)
                    if step is not None:
                        last_restore_step = step
                    continue
                error = outcome["error"]
                fatal = outcome["status"] == "fatal"
                handled = False
                if not fatal and elastic is not None:
                    from ray_tpu_torch.autoscaler.elastic import worker_capacity

                    # Shrink (or hold) the world to what the live cluster
                    # can host, restore the last committed step — memory
                    # replicas first — and requeue every rolled-back claim.
                    cap = worker_capacity(scfg.worker_resources())
                    target = max(elastic.min_workers,
                                 min(cap, elastic.resolve_max(scfg.num_workers)))
                    restore_ckpt, step = self._elastic_restore_point(
                        coordinator, manager)
                    if restore_ckpt is None:
                        restore_ckpt = self.resume_from_checkpoint
                    requeued = sum(ledger.rollback(step)
                                   for ledger in ledgers.values())
                    requeued += sum(ingest.rollback(step)
                                    for ingest in ingests.values())
                    last_step = outcome.get("last_step")
                    lost = 0
                    if last_step is not None:
                        lost = max(0, last_step
                                   - (step if step is not None else -1))
                    train_metrics.LOST_STEPS.inc(lost)
                    if target < cur_world:
                        train_metrics.SHRINK_EVENTS.inc()
                    event = {"type": "shrink" if target < cur_world
                             else "recover",
                             "from_world": cur_world, "to_world": target,
                             "restore_step": step, "lost_steps": lost,
                             "requeued_samples": requeued,
                             "time": time.time()}
                    self._elastic_event(run_name, elastic_events, event,
                                        outcome.get("failed_at")
                                        or time.monotonic())
                    # Preemption forensics: snapshot the black box before
                    # the recovery attempt overwrites the ring.
                    flight_recorder.trigger_dump("elastic_preempt", {
                        "run": run_name, "event": event,
                        "error": str(error) if error else ""})
                    cur_world = target
                    # A recovery "handles" the failure only when the
                    # cluster can still run AND the restore point advanced
                    # since the last one: failures pinned to one step burn
                    # max_failures like any other crash loop.
                    progressed = step is not None and (
                        last_restore_step is None or step > last_restore_step)
                    if step is not None:
                        last_restore_step = step
                    handled = cap >= elastic.min_workers and progressed
                if not handled:
                    failures += 1
                # "fatal" = retrying cannot help (e.g. infeasible
                # resources): return even under max_failures=-1.
                if fatal or (max_failures >= 0 and failures > max_failures):
                    run_registry.finish_run(run_name, "failed")
                    flight_recorder.trigger_dump("train_failed", {
                        "run": run_name, "attempts": attempt_no,
                        "error": repr(error)})
                    return result(outcome, error)
                if elastic is not None:
                    time.sleep(0.05)  # recovery latency is the product
                else:
                    restore_ckpt = self._restart_point(
                        run_name, attempt_no, outcome, failures, restarts,
                        coordinator, manager, ingests)
                attempt_no += 1
                run_registry.update_run(run_name, attempts=attempt_no)
        finally:
            # Device-telemetry rollup for the run row, when that plane is
            # loaded — best-effort.
            telemetry = sys.modules.get("ray_tpu_torch.util.device_telemetry")
            if telemetry is not None:
                try:
                    run_registry.update_run(
                        run_name, device_telemetry=telemetry.snapshot())
                except Exception:
                    pass
            # A raise out of the attempt loop must not leave the registry
            # row "running" forever.
            row = run_registry.get_run(run_name)
            if row is not None and row["status"] == "running":
                run_registry.finish_run(run_name, "failed")
            if coordinator is not None:
                ray_tpu_torch.kill(coordinator)
            self._snapshot_pools = []

    def _restart_point(self, run_name: str, attempt_no: int, outcome: Dict,
                       failures: int, restarts: List[Dict[str, Any]],
                       coordinator, manager: CheckpointManager,
                       ingests: Dict[str, Any]) -> Optional[Checkpoint]:
        """A fixed-world restart (ref: v2 controller RESTARTING state): back
        off, then the newest checkpoint. The coordinator's committed step
        wins — its replica tier restores without re-reading storage."""
        restarts.append({"attempt": attempt_no, "error": repr(outcome["error"]),
                         "failed_at": outcome["failed_at"], "resumed_s": None})
        flight_recorder.record_event(f"train.restart:{run_name}", {
            "attempt": attempt_no, "error": repr(outcome["error"])},
            kind="train")
        time.sleep(min(2.0 ** min(failures, 5) * 0.1, 5.0))  # backoff
        t0 = time.monotonic()
        restore_ckpt = self._coordinator_checkpoint(coordinator)
        restarts[-1]["restore"] = self._last_restore
        if restore_ckpt is not None:
            self._last_restore["seconds"] = time.monotonic() - t0
        # The restarted attempt re-runs the user loop from its own epoch 0:
        # ingest epochs start fresh too.
        for ingest in ingests.values():
            ingest.reset()
        return (restore_ckpt or manager.latest_checkpoint()
                or self.resume_from_checkpoint)

    def _elastic_event(self, run_name: str, events: List[Dict[str, Any]],
                       event: Dict[str, Any], t0: float) -> None:
        """Record a shrink/recover/grow and start its recovery clock."""
        events.append(event)
        run_registry.record_event(run_name, event)
        self._recovery_t0 = t0
        self._recovery_event = event

    def _close_recovery(self, resumed_at: float) -> None:
        """The first report after an elastic recovery landed: training
        resumed. Observes the failure -> resumed seconds and records the
        window as one ``train.elastic`` span."""
        dt = resumed_at - self._recovery_t0
        train_metrics.RECOVERY_SECONDS.observe(dt)
        ev = self._recovery_event
        now_w = time.time() - (time.monotonic() - resumed_at)
        tracing.record_span("train.elastic", now_w - dt, now_w,
                            attributes={"type": ev["type"],
                                        "from_world": ev["from_world"],
                                        "to_world": ev["to_world"],
                                        "restore_step": ev["restore_step"]})
        ev["recovery_seconds"] = dt
        self._recovery_t0 = None
        self._recovery_event = None

    # ------------------------------------------------ coordinator restore
    def _coordinator_checkpoint(self, coordinator,
                                from_memory: bool = True
                                ) -> Optional[Checkpoint]:
        """Checkpoint handle for the coordinator's latest committed step.

        Prefers the in-memory replica tier (full shard set resident): the
        handle's to_pytree() assembles the tree from the payloads and never
        touches the storage (the reference writes them to a local dir and
        reads that back); the peer holder's copies are next, the committed
        dir on storage the floor. ``_last_restore`` records which
        ({"source", "step"}), or None."""
        self._last_restore = None
        src = self._restore_source(coordinator)
        if src is None:
            return None
        if from_memory:
            for source, fetch in (("memory", self._memory_checkpoint),
                                  ("peer", self._peer_checkpoint)):
                ckpt = fetch(coordinator, src)
                if ckpt is not None:
                    self._last_restore = {"source": source,
                                          "step": src["step"]}
                    return ckpt
        self._last_restore = {"source": "disk", "step": src["step"]}
        return Checkpoint(src["path"])

    def _restore_source(self, coordinator) -> Optional[Dict]:
        if coordinator is None:
            return None
        try:
            return ray_tpu_torch.get(coordinator.restore_source.remote(),
                                     timeout=30)
        except (TaskError, RayTpuError):
            return None

    def _elastic_restore_point(self, coordinator, manager: CheckpointManager):
        """(checkpoint, step) to resume from after a preemption or grow:
        memory replicas -> peer holder payloads -> committed dir on disk ->
        the manager's checkpoints (step unknown there). Every remote fetch
        is bounded, so a dead holder or a lost object falls through to the
        next tier instead of hanging the recovery."""
        ckpt = self._coordinator_checkpoint(coordinator)
        if ckpt is not None:
            return ckpt, self._last_restore["step"]
        return manager.latest_checkpoint(), None

    def _memory_checkpoint(self, coordinator, src: Dict
                           ) -> Optional[Checkpoint]:
        """A handle on the object-store replica payloads; None when the set
        is absent or any ref is unfetchable within the bound."""
        if not src.get("replicas"):
            return None
        try:
            refs = src["replicas"]["refs"]
            payloads = {int(sid): ray_tpu_torch.get(w["ref"], timeout=20)
                        for sid, w in refs.items()}
        except Exception:
            return None
        return self._replica_checkpoint(src["path"], payloads, "memory")

    def _peer_checkpoint(self, coordinator, src: Dict
                         ) -> Optional[Checkpoint]:
        """The same, from the ReplicaHolder actor on a peer node: the tier
        that survives the writers' node."""
        try:
            res = ray_tpu_torch.get(
                coordinator.peer_payloads.remote(src["step"]), timeout=30)
        except (TaskError, RayTpuError):
            return None
        if not res:
            return None
        payloads = {int(sid): p for sid, p in res["payloads"].items()}
        return self._replica_checkpoint(src["path"], payloads, "peer")

    @staticmethod
    def _replica_checkpoint(path: str, payloads: Dict[int, dict],
                            source: str) -> Checkpoint:
        from ray_tpu_torch.checkpoint import metrics as ckpt_metrics
        from ray_tpu_torch.train.checkpoint import ReplicaCheckpoint

        ckpt_metrics.RESTORES.inc(tags={"source": source})
        return ReplicaCheckpoint(path, payloads)

    def _check_async_saves(self, sessions: List[TrainSession],
                           coordinator) -> Optional[BaseException]:
        """Async saves fail out-of-band (drain deliberately swallows them so
        a later commit can supersede); a run where NO save ever committed
        must not finish silently with checkpoint=None and no error."""
        reported = sum(s.async_saves_reported for s in sessions)
        if not reported or coordinator is None:
            return None
        try:
            latest = ray_tpu_torch.get(coordinator.latest_committed.remote(),
                                       timeout=30)
        except (TaskError, RayTpuError):
            return None
        if latest is not None:
            return None
        causes = []
        for s in sessions:
            handle = s.last_save_handle
            if handle is None or not handle.done():
                continue
            exc = handle.exception(timeout=0)
            if exc is not None:
                causes.append(repr(exc))
        import logging

        err = RuntimeError(
            f"{reported} async checkpoint save(s) were reported but no step "
            "ever committed — the run finished without a usable checkpoint"
            + (f"; last shard errors: {causes}" if causes else ""))
        logging.getLogger(__name__).warning("%s", err)
        return err

    def _committed_step(self, coordinator) -> Optional[int]:
        if coordinator is None:
            return None
        try:
            return ray_tpu_torch.get(coordinator.latest_committed.remote(),
                                     timeout=30)
        except (TaskError, RayTpuError):
            return None

    def _preempt_worker_node(self, pg) -> Optional[str]:
        """The preempt_node chaos hook: take out a whole node hosting
        worker-group bundles (never the head: the controller lives there)."""
        from ray_tpu_torch._private.runtime import get_runtime
        from ray_tpu_torch.autoscaler.elastic import simulate_preemption

        head = str(get_runtime().head_node_id)
        victim = next((n for n in pg.bundle_node_ids()
                       if n is not None and n != head), None)
        return simulate_preemption(victim)

    # ---------------------------------------------------------- one attempt
    def _run_attempt(self, run_name: str, manager: CheckpointManager,
                     restore_ckpt: Optional[Checkpoint],
                     ingests: Dict[str, Any], coordinator=None,
                     world: Optional[int] = None,
                     ledgers: Optional[Dict[str, SampleLedger]] = None) -> Dict:
        scfg = self.scaling_config
        if world is None:
            world = scfg.num_workers
        if scfg.elastic is not None:
            # A stable group name re-formed per attempt: a rank of a
            # preempted attempt still blocked in a rendezvous wakes with an
            # error, and the group's world follows the elastic world.
            group_name = f"train-{run_name}"
            collective.reform_collective_group(world, group_name=group_name)
        else:
            DataParallelTrainer._collective_counter += 1
            group_name = (f"train-{run_name}-"
                          f"{DataParallelTrainer._collective_counter}")

        # Gang-schedule the worker group via a placement group
        # (ref: backend_executor.py placement group per worker group).
        bundles = [scfg.worker_resources() for _ in range(world)]
        # Infeasible-by-construction requests fail now, not after the
        # reservation timeout.
        from ray_tpu_torch._private.runtime import get_runtime

        scheduler = get_runtime().scheduler
        for bundle in bundles:
            if not scheduler.feasible(bundle):
                return {"status": "fatal", "last_metrics": None, "history": [],
                        "error": RuntimeError(
                            f"Worker bundle {bundle} fits no node in the cluster "
                            f"(total: {ray_tpu_torch.cluster_resources()})")}
        pg = placement_group(bundles, strategy=scfg.placement_strategy)
        try:
            if not pg.wait(timeout_seconds=PG_WAIT_S):
                return {"status": "failed", "last_metrics": None,
                        "history": [], "failed_at": time.monotonic(),
                        "error": RuntimeError(
                            f"Could not reserve {world}x{scfg.worker_resources()} "
                            f"for the worker group within {PG_WAIT_S:.0f}s "
                            f"(cluster: {ray_tpu_torch.cluster_resources()}). "
                            f"Reduce num_workers/resources_per_worker or add "
                            f"nodes.")}
            return self._run_with_pg(pg, run_name, group_name, manager,
                                     restore_ckpt, ingests, coordinator,
                                     world=world, ledgers=ledgers or {})
        finally:
            collective.destroy_collective_group(group_name)
            remove_placement_group(pg)

    def _worker_mode(self, pg) -> str:
        """threads (one host, shared process) vs processes (one
        torch.distributed rank per worker process — what a group that spans
        nodes needs: a thread here cannot run on another host)."""
        mode = self.scaling_config.worker_mode
        if mode in ("threads", "processes"):
            return mode
        if mode != "auto":
            raise ValueError(f"worker_mode must be auto|threads|processes, got {mode!r}")
        from ray_tpu_torch._private.runtime import get_runtime

        head = str(get_runtime().head_node_id)
        return "processes" if any(
            n is not None and n != head for n in pg.bundle_node_ids()
        ) else "threads"

    def _run_with_pg(self, pg, run_name: str, group_name: str,
                     manager: CheckpointManager, restore_ckpt,
                     ingests: Dict[str, Any], coordinator=None,
                     world: Optional[int] = None,
                     ledgers: Optional[Dict[str, SampleLedger]] = None) -> Dict:
        scfg = self.scaling_config
        elastic = scfg.elastic
        if self._worker_mode(pg) == "processes":
            if elastic is not None:
                return {"status": "fatal", "last_metrics": None,
                        "history": [], "error": ValueError(
                            "elastic training requires thread-tier workers "
                            "(the sample ledger and replica restore live in "
                            "the controller's process); use ScalingConfig("
                            "worker_mode='threads')")}
            if coordinator is not None:
                return {"status": "fatal", "last_metrics": None,
                        "history": [], "error": ValueError(
                            "CheckpointConfig(async_save=True) needs "
                            "thread-tier workers (a process rank's shard "
                            "writer is not ported: ROADMAP.md, Queue 1 item "
                            "6); use ScalingConfig(worker_mode='threads')")}
            return self._run_distributed(pg, run_name, group_name, manager,
                                         restore_ckpt)
        if world is None:
            world = scfg.num_workers
        ledgers = ledgers or {}
        train_metrics.WORLD_SIZE.set(world)
        run_registry.update_run(run_name, world_size=world)
        dataset_shards = self._split_datasets(
            world, exclude=set(ledgers) | set(ingests))
        writers: List = []
        start_step = 0
        if coordinator is not None:
            from ray_tpu_torch.checkpoint import ShardWriter

            # New attempt = new epoch: shards from a crashed attempt's
            # in-flight saves can no longer mix into this attempt's steps.
            epoch = ray_tpu_torch.get(coordinator.new_epoch.remote(),
                                      timeout=30)
            latest = self._committed_step(coordinator)
            start_step = (latest + 1) if latest is not None else 0
            writers = [ShardWriter(coordinator, shard_id=rank,
                                   world_size=world, epoch=epoch,
                                   pool=self._snapshot_pools[rank])
                       for rank in range(world)]
        sessions: List[TrainSession] = []
        workers = []
        for rank in range(world):
            ctx = TrainContext(world_rank=rank, world_size=world, local_rank=rank,
                               trial_name=run_name, experiment_name=run_name,
                               group_name=group_name)
            session = TrainSession(ctx, checkpoint_to_restore=restore_ckpt,
                                   dataset_shards=dataset_shards[rank],
                                   shard_writer=(writers[rank] if writers
                                                 else None),
                                   start_step=start_step,
                                   dataset_config=self.dataset_config,
                                   profiler=(StepProfiler(run_name=run_name,
                                                          rank=rank)
                                             if self.run_config.profile
                                             else None))
            # Elastic datasets are views onto the shared ledger, bound to
            # this session so claims carry its next checkpoint step.
            for name, ledger in ledgers.items():
                session.dataset_shards[name] = ElasticDatasetShard(ledger,
                                                                   session)
            # Streaming datasets: a per-session view onto the shared ingest.
            for name, ingest in ingests.items():
                session.dataset_shards[name] = ingest.make_shard(session)
            sessions.append(session)
            workers.append(
                TrainWorker.options(
                    resources=scfg.worker_resources(),
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=rank),
                ).remote(rank, world, group_name)
            )
        #: The last attempt's sessions (their profilers hold the per-step
        #: attribution rows).
        self.sessions = sessions
        refs = [w.run.remote(self.train_loop, self.train_loop_config, s)
                for w, s in zip(workers, sessions)]

        drained = _Drain(manager)
        pending = list(refs)
        statuses: List[str] = []
        grow_target: Optional[int] = None
        desired_max = (elastic.resolve_max(scfg.num_workers)
                       if elastic is not None else world)
        last_health = last_seal = 0.0
        last_grow_check = time.monotonic()
        grow_first_exit: Optional[float] = None
        grow_woke = False

        def drain() -> None:
            drained.sessions(sessions)
            if self._recovery_t0 is not None and \
                    drained.first_report_at is not None:
                self._close_recovery(drained.first_report_at)

        def seal_committed() -> None:
            # Ledger and streaming-ingest claims are provisional under
            # async saves: seal them as the coordinator commits their
            # steps (sealed samples never requeue on a rollback).
            committed = self._committed_step(coordinator)
            if committed is not None:
                run_registry.update_run(run_name,
                                        last_committed_step=committed)
                for ledger in ledgers.values():
                    ledger.seal(committed)
                for ingest in ingests.values():
                    ingest.seal(committed)

        try:
            while pending:
                ready, pending = ray_tpu_torch.wait(
                    pending, num_returns=len(pending), timeout=0.05)
                drain()
                now = time.monotonic()
                if (ledgers or ingests) and coordinator is not None and \
                        now - last_seal >= 0.25:
                    last_seal = now
                    seal_committed()
                # Liveness: a killed thread-tier worker's actor dies but its
                # in-flight run() thread does NOT — the ref would never
                # resolve, so the controller polls actor health itself.
                if now - last_health >= 0.25:
                    last_health = now
                    dead = self._dead_workers(workers)
                    if dead:
                        from ray_tpu_torch.exceptions import WorkerCrashedError

                        raise WorkerCrashedError(
                            f"{len(dead)} train worker(s) died (ranks "
                            f"{sorted(dead)}; node preempted?)")
                # Chaos: a whole worker node vanishes (the injector as the
                # config stands now, so a test can arm it mid-run).
                injector = fault_injection.get_injector()
                if injector.enabled and injector.fires("preempt_node"):
                    self._preempt_worker_node(pg)
                # Grow back toward the target world at a checkpoint boundary
                # once capacity returns (and there is a step to restore:
                # growing without one would train from scratch).
                if (elastic is not None and grow_target is None
                        and world < desired_max
                        and now - last_grow_check >= elastic.grow_check_period_s):
                    last_grow_check = now
                    from ray_tpu_torch.autoscaler.elastic import worker_capacity

                    target = min(worker_capacity(scfg.worker_resources()),
                                 desired_max)
                    has_restore = (self._committed_step(coordinator) is not None
                                   or manager.latest_checkpoint() is not None)
                    if target > world and has_restore:
                        grow_target = target
                        # report() IS the checkpoint boundary: each rank
                        # raises StopIteration there and returns "stopped".
                        for s in sessions:
                            s.stop_requested.set()
                for r in ready:
                    try:
                        statuses.append(ray_tpu_torch.get(r))  # raise worker errors
                    except (TaskError, RayTpuError) as err:
                        if grow_target is None:
                            raise
                        # Woken mid-rendezvous by the boundary wake below:
                        # its uncommitted claims roll back with the grow's
                        # restore, so this is a clean stop.
                        _drop_frames(err)
                        statuses.append("stopped")
                # Ranks see the grow stop at different points: one can exit
                # at its report() while a peer already waits in the next
                # collective for a partner that will never come. Once one
                # has exited, give the rest a grace second to reach their
                # own boundary, then wake them by destroying the group.
                if grow_target is not None and statuses and pending:
                    if grow_first_exit is None:
                        grow_first_exit = now
                    elif not grow_woke and now - grow_first_exit >= 1.0:
                        grow_woke = True
                        self._destroy_group(group_name)
            drain()
            # Async saves still persisting belong to this run: let them land
            # (and commit) before declaring it finished — and, on a grow,
            # before the restore point is chosen.
            _settle(writers)
            if (ledgers or ingests) and coordinator is not None:
                seal_committed()
            # A grow stop surfaces two ways: ranks that hit report() raise
            # StopIteration ("stopped"), ranks whose loop ended on the
            # ledger's fence come back "done" — work left in a ledger tells
            # that apart from the end of the data.
            work_left = any(not led.exhausted() for led in ledgers.values()) \
                or any(not ing.exhausted() for ing in ingests.values())
            if grow_target is not None and ("stopped" in statuses or work_left):
                return {"status": "grow", "new_world": grow_target,
                        "last_metrics": drained.last_metrics,
                        "history": drained.history, "error": None}
            return drained.outcome(
                "finished", error=self._check_async_saves(sessions,
                                                          coordinator))
        except (TaskError, RayTpuError) as e:  # a worker failed
            failed_at = time.monotonic()
            # A rank whose actor died (killed, or its node preempted) is
            # fenced: what its thread still reports is dropped. Every rank
            # stops at its next boundary: a report (kept, then
            # StopIteration), a collective (the group is destroyed) or a
            # ledger claim (refused).
            for rank in self._dead_workers(workers):
                sessions[rank].fence()
            for s in sessions:
                s.stop_requested.set()
            self._destroy_group(group_name)
            for w in workers:
                ray_tpu_torch.kill(w)
            # Queued-but-unstarted async saves die with the attempt (their
            # epoch is stale anyway). The persist in flight may still
            # commit, which is always safe — its snapshot is whole — and
            # is waited for (bounded), so that the restart's restore point
            # includes it: on the card a persist outlasts a few steps.
            for wtr in writers:
                wtr.abort()
            # Keep what every rank reported before it stopped, so that a
            # rank's report of a step it finished never races the drain;
            # a rank that outlasts the bound is abandoned.
            ray_tpu_torch.wait(refs, num_returns=len(refs),
                               timeout=RANK_STOP_S)
            # The stopped ranks' errors must not keep their state on the
            # card through the attempts that follow.
            for r in refs:
                try:
                    ray_tpu_torch.get(r, timeout=0)
                except (TaskError, RayTpuError) as err:
                    _drop_frames(err)
            _settle(writers)
            drain()
            # The newest coordinator step any rank reported (its save may
            # or may not have committed): the elastic controller's lost
            # steps are this minus the restore step.
            last_step = max((s.current_checkpoint_step() - 1
                             for s in sessions), default=-1)
            return drained.outcome("failed", error=_drop_frames(e),
                                   failed_at=failed_at,
                                   last_step=last_step if last_step >= 0
                                   else None)
        finally:
            for w in workers:
                ray_tpu_torch.kill(w)

    @staticmethod
    def _destroy_group(group_name: str) -> None:
        """Wake every rank blocked in the group's rendezvous."""
        try:
            collective.get_collective_group(group_name).destroy()
        except ValueError:
            pass

    def _dead_workers(self, workers) -> List[int]:
        """Ranks whose worker actor is no longer alive (killed, or its node
        preempted)."""
        from ray_tpu_torch._private.runtime import get_runtime

        runtime = get_runtime()
        dead = []
        for rank, w in enumerate(workers):
            state = runtime.get_actor_state(w._ray_actor_id)
            if state is None or state.state == "DEAD":
                dead.append(rank)
        return dead

    # --------------------------------------------------- process attempt
    def _run_distributed(self, pg, run_name: str, group_name: str,
                         manager: CheckpointManager, restore_ckpt) -> Dict:
        """One attempt with process-tier workers: rank 0 reserves the
        rendezvous address, every worker joins with its placement-group
        rank, and the group's collectives become process-group calls (ref:
        backend_executor.py _setup_worker_group + torch/config.py:115)."""
        from ray_tpu_torch.util.queue import Empty, Queue

        scfg = self.scaling_config
        world = scfg.num_workers
        if self.datasets:
            return {"status": "fatal", "last_metrics": None, "history": [],
                    "error": ValueError(
                        "datasets= require thread-tier workers (streaming "
                        "iterators cannot cross process boundaries); use "
                        "ScalingConfig(worker_mode='threads') or load data "
                        "inside the train_loop")}
        workers = []
        contexts: List[TrainContext] = []
        for rank in range(world):
            contexts.append(TrainContext(
                world_rank=rank, world_size=world, local_rank=rank,
                trial_name=run_name, experiment_name=run_name,
                group_name=group_name))
            workers.append(
                CudaDistTrainWorker.options(
                    isolation="process",
                    resources=scfg.worker_resources(),
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=pg, placement_group_bundle_index=rank),
                ).remote(rank, world, group_name))

        report_queue = Queue()
        drained = _Drain(manager)

        def drain() -> None:
            while True:
                try:
                    item = report_queue.get_nowait()
                except Empty:
                    return
                drained.item(item["rank"], item["metrics"],
                             unpack_checkpoint(item["checkpoint_blob"]))

        try:
            coord = ray_tpu_torch.get(workers[0].reserve_coordinator.remote(),
                                      timeout=120)
            #: The ranks' topology as each reported it from setup().
            self.process_topology = ray_tpu_torch.get(
                [w.setup.remote(coord, scfg.backend) for w in workers],
                timeout=300)
            blob = pack_checkpoint(restore_ckpt)
            refs = [w.run.remote(self.train_loop, self.train_loop_config, ctx,
                                 report_queue, blob)
                    for w, ctx in zip(workers, contexts)]
            _drive_worker_refs(refs, drain)
            for w in workers:
                try:
                    ray_tpu_torch.get(w.teardown.remote(), timeout=15)
                except (TaskError, RayTpuError):
                    pass  # the process is discarded below either way
            return drained.outcome("finished")
        except (TaskError, RayTpuError) as e:
            # A dead worker leaves the others wedged inside a collective;
            # killing their processes (finally below) unblocks the restart.
            failed_at = time.monotonic()
            drain()
            return drained.outcome("failed", error=e, failed_at=failed_at)
        finally:
            for w in workers:
                ray_tpu_torch.kill(w)
            report_queue.shutdown()

    def _split_datasets(self, world: int, exclude=()) -> List[Dict[str, Any]]:
        """Per-rank dataset shards (ref: StreamSplitDataIterator coordinated
        split for Train ingest, data/_internal/iterator/stream_split_iterator.py:31).
        Names in ``exclude`` are served by streaming ingest instead."""
        shards: List[Dict[str, Any]] = [{} for _ in range(world)]
        for name, ds in self.datasets.items():
            if name in exclude:
                continue
            if hasattr(ds, "streaming_split"):
                its = ds.streaming_split(world)
                for rank in range(world):
                    shards[rank][name] = its[rank]
            else:
                for rank in range(world):
                    shards[rank][name] = ds
        return shards


class _Drain:
    """What one attempt's reports leave behind: checkpoints from ANY rank
    are registered (a loop where a non-zero rank carries the checkpoint
    must not lose progress); metrics history follows rank 0 (the
    reference's convention)."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self.last_metrics: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []
        self.first_report_at: Optional[float] = None

    def item(self, rank: int, metrics: Dict[str, Any],
             checkpoint: Optional[Checkpoint]) -> None:
        if self.first_report_at is None:
            self.first_report_at = time.monotonic()
        if checkpoint is not None:
            self.manager.register(checkpoint, metrics)
        if rank == 0:
            self.last_metrics = metrics
            self.history.append(metrics)

    def sessions(self, sessions: List[TrainSession]) -> None:
        for session in sessions:
            while True:
                try:
                    item = session.results.get_nowait()
                except queue.Empty:
                    break
                self.item(item["rank"], item["metrics"], item["checkpoint"])

    def outcome(self, status: str, error: Optional[BaseException] = None,
                failed_at: Optional[float] = None,
                last_step: Optional[int] = None) -> Dict[str, Any]:
        return {"status": status, "last_metrics": self.last_metrics,
                "history": self.history, "error": error,
                "failed_at": failed_at, "last_step": last_step,
                "first_report_at": self.first_report_at}


class CudaTrainer(DataParallelTrainer):
    """The GPU trainer: the counterpart of ``JaxTrainer`` (BASELINE north
    star: ``JaxTrainer`` pinning workers to TPU processes; here workers
    pinned to cards). The same controller; ``use_gpu`` (the default)
    reserves ``gpus_per_worker`` of a card per worker, each rank reads its
    card from ``get_gpu_ids()`` (``_private/device.py:granted_cuda_device``),
    and ``ray_tpu_torch.collective.allreduce`` inside the loop syncs the
    gradients.

    On one node the workers are threads sharing the process and its CUDA
    context; ranks that share a card share it. With
    ``ScalingConfig(worker_mode="processes")`` each worker is its own
    process on its own card, joined into one NCCL group, and the same
    train_loop runs unchanged. That is the mesh mode: inside the loop the
    ranks build ``parallel.make_mesh(MeshSpec(...))`` over their process
    group and train on DTensors (``parallel.create_sharded_state``,
    ``collective.distributed.local_batch_to_global``), multi-controller
    SPMD as in the reference, on any of its axes: ``seq`` rings the
    sequence shards between the ranks and ``pipe`` runs the GPipe
    schedule across them. Ranks that share one card
    (``gpus_per_worker < 1``) join over gloo, which the caller asks for
    with ``ScalingConfig(backend="gloo")``."""
