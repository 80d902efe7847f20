"""The core runtime of the port: its thread tier (the counterpart of
``ray_tpu/_private/runtime.py``; ref: src/ray/core_worker/core_worker.h:166,
src/ray/raylet/node_manager.h:117), collapsed into one in-process control
plane:

* task manager — pending task bookkeeping, retries, lineage-based object
  reconstruction (ref: task_manager.h:212);
* dispatcher — dependency wait (ref: dependency_manager.h:49), then resource
  acquisition through the ClusterScheduler, then execution on a thread;
* actor manager — actor FSM with restarts (ref: gcs_actor_manager.h:312),
  ordered mailboxes, threaded and async actors, named actors;
* driver API — get/put/wait/cancel/kill, lending a task's CPUs back while
  it blocks in get (the reference's "worker blocked in ray.get" release).

Tasks and actors run on threads of this process, which share one CUDA
context, unless they ask for the process tier (``isolation="process"`` or a
``runtime_env``): then they run in spawned worker processes of
``_private/process_pool.py``, each of which sees only the cards its lease
was granted. A replica that serves a model on the GPU is an actor here, and
reads the card its lease was granted from ``get_gpu_ids()``.

The head is one node of the scheduler; ``cluster_utils.Cluster`` adds
virtual nodes beside it, each with its resources, labels and its share of
the host's cards. Work placed on a virtual node runs in this process like
the head's. ``remove_node`` takes a node out as its loss would: the tasks
running there fail over (retried elsewhere within their ``max_retries``,
else ``WorkerCrashedError``; a thread that cannot be stopped runs on and its
result is dropped), and its actors restart elsewhere within
``max_restarts`` or die with ``ActorDiedError``.

The object store (``_private/object_store.py``) holds values by reference
and, in its serialized tier, wire forms in a shared-memory arena that every
process worker attaches: arguments and results above
``plasma_handoff_threshold`` cross through it instead of the pipe, and a
process task's or actor call's result is stored as its wire form there
(spilled to disk under pressure), deserialized on first ``get``. Real
worker nodes, the object server, borrowing and the memory monitor are not
ported yet (ROADMAP.md, Queue 1 item 13.8b).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import os
import queue
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import fault_injection, metrics_agent, serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG, Config
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    put_counter,
)
from ray_tpu_torch._private.object_ref import ObjectRef, global_refcounter
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch._private.process_pool import ProcessPool, stop_log_monitor
from ray_tpu_torch._private.scheduling import (
    ClusterScheduler,
    InfeasibleError,
    Lease,
    SpreadStrategy,
)
from ray_tpu_torch._private.task_spec import ActorSpec, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.util import tracing

_runtime_lock = threading.Lock()
_runtime: Optional["Runtime"] = None

#: Dispatcher wake token: retry the blocked list (see _notify_resources_freed).
_RETRY_BLOCKED = object()

#: How long shutdown() waits, in all, for the actors' threads to end.
_SHUTDOWN_JOIN_S = 2.0

_task_ctx = threading.local()


class TaskContext:
    """Per-execution context (ref: runtime_context.py RuntimeContext)."""

    __slots__ = ("task_id", "actor_id", "lease", "cancelled", "gpu_ids",
                 "node_lost")

    def __init__(self, task_id: TaskID, actor_id: Optional[ActorID] = None,
                 lease: Optional[Lease] = None, gpu_ids: Tuple[int, ...] = ()):
        self.task_id = task_id
        self.actor_id = actor_id
        #: A task's own lease, lent back while the task blocks in get (an
        #: actor's lease is held for its lifetime: None here).
        self.lease = lease
        self.cancelled = threading.Event()
        #: The GPU indices of the task's or actor's lease.
        self.gpu_ids = gpu_ids
        #: Set when the task's node was removed under it: the task already
        #: failed over, and what its thread returns is dropped.
        self.node_lost = False


def current_task_context() -> Optional[TaskContext]:
    return getattr(_task_ctx, "ctx", None)


class ObjectRefGenerator:
    """Streaming generator returns (ref: _raylet.pyx streaming generator
    protocol): yields ObjectRefs as the remote generator yields."""

    def __init__(self, task_id: TaskID):
        self._task_id = task_id
        self._queue: "queue.Queue" = queue.Queue()

    def _push(self, ref: ObjectRef) -> None:
        self._queue.put(ref)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self._queue.put(StopIteration if error is None else error)

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        item = self._queue.get()
        if item is StopIteration:
            self._queue.put(StopIteration)
            raise StopIteration
        if isinstance(item, BaseException):
            self._queue.put(item)
            raise item
        return item

    def __aiter__(self):
        return self

    async def __anext__(self):
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration from None


class _ActorState:
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"

    def __init__(self, spec: ActorSpec):
        self.spec = spec
        self.state = _ActorState.PENDING
        self.instance: Any = None
        # SimpleQueue: C-implemented put/get, the cheapest FIFO wake-up.
        self.mailbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self.threads: List[threading.Thread] = []
        self.lease: Optional[Lease] = None
        #: The dedicated worker process hosting the instance, when the actor
        #: asked for the process tier (see _start_actor).
        self.proc_worker = None
        self.num_restarts = 0
        self.death_cause: Optional[BaseException] = None
        self.ready_event = threading.Event()
        self.lock = threading.Lock()
        #: The node the instance was placed on (its lease's).
        self.node_id: Optional[NodeID] = None
        self.is_async = any(
            inspect.iscoroutinefunction(getattr(spec.cls, m, None))
            for m in dir(spec.cls)
            if not m.startswith("__") or m == "__call__"
        )


class _LeanExecPool:
    """Futures-free task executor: SimpleQueue dispatch to daemon threads,
    spawning a new thread only when none is idle (bounded)."""

    def __init__(self, max_threads: int = 512, name: str = "worker"):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._max = max_threads
        self._name = name
        #: Workers parked in q.get() whose next wake-up no submit has
        #: claimed. Every queued item holds exactly one claim (an idle
        #: permit or a freshly spawned thread), so no item is stranded.
        self._idle = 0
        self._nthreads = 0
        self._stopped = False
        self._lock = threading.Lock()

    def submit(self, fn, *args, **kwargs) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("cannot submit after shutdown")
            if self._idle > 0:
                self._idle -= 1  # claim a parked worker's next wake
            elif self._nthreads < self._max:
                self._nthreads += 1
                threading.Thread(
                    target=self._run,
                    name=f"{self._name}-{self._nthreads}",
                    daemon=True,
                ).start()
            # else: at capacity — an active worker claims it via the idle+1
            # it posts after finishing its current item.
        self._q.put((fn, args, kwargs))

    def _run(self) -> None:
        # A new thread's first wake is pre-claimed by the submit that
        # spawned it, so it parks without posting an idle permit.
        while True:
            item = self._q.get()
            if item is None:
                with self._lock:
                    self._nthreads -= 1
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except Exception:  # never kill the pool thread
                traceback.print_exc()
            with self._lock:
                if self._stopped:
                    self._nthreads -= 1
                    return
                self._idle += 1

    def shutdown(self) -> None:
        """Stop taking work, drop what is queued, wake every thread to
        exit (queued work must not run against a torn-down runtime)."""
        with self._lock:
            self._stopped = True
            n = self._nthreads
            self._idle = 0
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for _ in range(n):
            self._q.put(None)


class Runtime:
    """Singleton per process; created by ray_tpu_torch.init()."""

    def __init__(
        self,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        _system_config: Optional[dict] = None,
        namespace: str = "default",
        labels: Optional[Dict[str, str]] = None,
    ):
        GLOBAL_CONFIG.apply_overrides(_system_config)
        self.config: Config = GLOBAL_CONFIG
        # The chaos flag may have changed: rebuild the injector from it.
        fault_injection.reset_injector()
        self.job_id = JobID.from_random()
        self.worker_id = WorkerID.from_random()
        self.namespace = namespace

        # Head node resources: the cards torch counts (no CUDA context is
        # created for the count), unless the caller says how many; the
        # caller's labels over the detected ones.
        from ray_tpu_torch._private.accelerators import detect_accelerators

        base: Dict[str, float] = {
            "CPU": float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))}
        accel_res, accel_labels = detect_accelerators()
        if num_gpus is not None:
            accel_res = {"GPU": float(num_gpus)} if num_gpus else {}
        base.update(accel_res)
        base.update(resources or {})
        base.setdefault("memory", float(self.config.object_store_memory
                                        or _default_memory_bytes()))
        self.scheduler = ClusterScheduler()
        # Validates the resources: nothing shared is touched before it.
        self.head_node_id = self.scheduler.add_node(
            base, {**accel_labels, **(labels or {})})

        self.store = ObjectStore(int(base["memory"]))
        self.refcounter = global_refcounter()
        self.refcounter.set_zero_callback(self._on_zero_refs)

        # Task bookkeeping.
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        # RLock: a lineage pop can GC an ObjectRef whose zero-callback
        # re-enters _on_zero_refs on this same thread.
        self._lineage_lock = threading.RLock()
        self._pending_deps: Dict[TaskID, Tuple[TaskSpec, set]] = {}
        self._obj_waiters: Dict[ObjectID, List[TaskID]] = {}
        self._deps_lock = threading.Lock()
        self._ready: "queue.Queue" = queue.Queue()
        self._running: Dict[TaskID, TaskContext] = {}
        #: The specs of the tasks in ``_running`` (a node's loss fails
        #: them over).
        self._running_specs: Dict[TaskID, TaskSpec] = {}
        self._cancelled: set = set()
        self._generators: Dict[TaskID, ObjectRefGenerator] = {}
        #: Tasks submitted but not yet finished/failed — lets get() tell
        #: "still computing" apart from "object lost, reconstruct".
        self._inflight: set = set()

        # Actors.
        self._actors: Dict[ActorID, _ActorState] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._actors_lock = threading.Lock()

        # Task events for the state API (ref: gcs_task_manager.h:86).
        self.task_events: deque = deque(maxlen=self.config.max_task_events)

        # The process tier: spawned workers, and those busy with a task.
        self.process_pool = ProcessPool(self.store.arena_path,
                                        self.store.plasma)
        self._leased_workers: Dict[int, Any] = {}
        self._leased_lock = threading.Lock()

        # Thread cache for tasks; resource accounting limits concurrency.
        self._exec_pool = _LeanExecPool(max_threads=512, name="ray_tpu_torch_worker")
        self._dispatcher_stop = threading.Event()
        self._blocked_count = 0
        self._retry_pending = False
        self.scheduler.on_release = self._notify_resources_freed
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="ray_tpu_torch_dispatcher", daemon=True
        )
        self._dispatcher.start()

    # ------------------------------------------------------------------ events
    def _emit_event(self, task_id: TaskID, name: str, state: str, **extra) -> None:
        # deque.append is atomic under the GIL: no lock on the hot path.
        self.task_events.append(
            {"task_id": str(task_id), "name": name, "state": state,
             "time": time.time(), **extra}
        )
        if state in ("FINISHED", "FAILED"):
            metrics_agent.record_task_finished(state == "FINISHED")

    # ------------------------------------------------------------------- puts
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("Calling put() on an ObjectRef is not allowed.")
        object_id = ObjectID.from_put(put_counter.next(), self.worker_id[:8])
        self.store.put(object_id, value)
        return ObjectRef(object_id, owner="driver")

    # ------------------------------------------------------- leased workers
    def _track_leased_worker(self, worker) -> None:
        """Register a process worker busy with a task (stack dumps and
        shutdown find it here; the reference's memory monitor also picks
        its victims among these)."""
        with self._leased_lock:
            self._leased_workers[id(worker)] = worker

    def _untrack_leased_worker(self, worker) -> None:
        with self._leased_lock:
            self._leased_workers.pop(id(worker), None)

    # --------------------------------------------------- cluster introspection
    def _remote_owner_addr(self, ref) -> str:
        """The address of the node holding ``ref``'s value: ``""``, this
        node, since the runtime has one (the reference names a remote node
        here; data ingest orders its shard claims by it)."""
        return ""

    def cluster_resources(self) -> Dict[str, float]:
        return self.scheduler.cluster_resources()

    def available_resources(self) -> Dict[str, float]:
        return self.scheduler.available_resources()

    def nodes(self) -> List[dict]:
        return [n.snapshot() for n in self.scheduler.nodes()]

    def remove_node(self, node_id) -> bool:
        """Take a node out as its loss would (ref: the raylet's node-death
        handling, node_manager.h): the tasks running there fail over and
        its actors restart elsewhere or die. False for an unknown node."""
        node = self.scheduler.get_node(node_id)
        if node is None or not self.scheduler.remove_node(node.id):
            return False
        lost = [ctx for ctx in list(self._running.values())
                if ctx.actor_id is None and ctx.lease is not None
                and ctx.lease.node_id == node.id]
        for ctx in lost:
            ctx.node_lost = True
            spec = self._running_specs.get(ctx.task_id)
            if spec is not None:
                self._handle_task_failure(spec, WorkerCrashedError(
                    f"task {spec.name}: its node {node.id} died"))
        with self._actors_lock:
            actors = [st for st in self._actors.values()
                      if st.node_id == node.id
                      and st.state != _ActorState.DEAD]
        for state in actors:
            self._kill_actor_state(state, ActorDiedError(
                f"actor's node {node.id} died"), no_restart=False)
        return True

    def list_task_events(self) -> List[dict]:
        # Appends are lock-free; list(deque) can raise if an append lands
        # mid-copy — retry.
        for attempt in range(64):
            try:
                return list(self.task_events)
            except RuntimeError:
                if attempt > 8:
                    time.sleep(0.001)
        raise RuntimeError(
            "task-event snapshot kept colliding with concurrent appends")

    # ------------------------------------------------------------------- gets
    def get(self, refs: Any, timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        values, missing = self.store.try_get_many([r.id for r in ref_list])
        if not missing:
            return values[0] if single else values
        ctx = current_task_context()
        released = False
        if ctx is not None and ctx.lease is not None:
            # Lend this task's CPUs back while blocked.
            self.scheduler.suspend(ctx.lease)
            released = True
        try:
            # One deadline for the whole get, however many refs wait.
            deadline = None if timeout is None else time.monotonic() + timeout
            for i in missing:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                values[i] = self._get_one(ref_list[i], remaining)
        finally:
            if released:
                self.scheduler.resume(ctx.lease)
        return values[0] if single else values

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout

        def _remaining() -> Optional[float]:
            return None if deadline is None \
                else max(0.0, deadline - time.monotonic())

        reconstructs = 0
        while True:
            if self.store.contains(ref.id):
                try:
                    return self.store.get(ref.id, _remaining())
                except ObjectLostError:
                    spec = self._lineage_for(ref.id)
                    reconstructs += 1
                    if spec is None or reconstructs > 3:
                        raise
                    # Drop the freed entry so the loop waits for the
                    # reconstruction instead of re-reading the error.
                    self.store.free(ref.id)
                    self._resubmit(spec)
                    continue
            if ref.id.task_id() in self._inflight:
                # Still computing: wait for a value or an error.
                if not self.store.wait_ready(ref.id, _remaining()):
                    raise GetTimeoutError(
                        f"Timed out waiting for object {ref.id}")
                continue
            # Not in flight and no value: lost — try lineage
            # (ref: object_recovery_manager.h:38).
            spec = self._lineage_for(ref.id)
            if spec is not None:
                self._resubmit(spec)
                continue
            return self.store.get(ref.id, _remaining())

    async def get_async(self, ref: ObjectRef) -> Any:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._get_one, ref, None)

    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(self._get_one(ref, None))
            except BaseException as e:  # noqa: BLE001 — handed to the future
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        if not refs:
            return [], []
        refs = list(refs)
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while len(ready) < num_returns:
            progressed = False
            for r in list(pending):
                if self.store.contains(r.id):
                    ready.append(r)
                    pending.remove(r)
                    progressed = True
                    if len(ready) >= num_returns:
                        break
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not progressed:
                remaining = 0.01 if deadline is None else min(0.01, deadline - time.monotonic())
                if pending and remaining > 0:
                    self.store.wait_ready(pending[0].id, remaining)
                elif remaining <= 0:
                    break
        return ready, pending

    # ---------------------------------------------------------------- submits
    def submit_task(self, spec: TaskSpec) -> Any:
        if tracing.is_tracing_enabled():
            with tracing.span(f"submit::{spec.name}",
                              attributes={"task_id": spec.task_id}):
                tracing.inject_task_spec(spec)
                return self._submit_task_inner(spec)
        return self._submit_task_inner(spec)

    def _submit_task_inner(self, spec: TaskSpec) -> Any:
        # One refcounter pass for all return handles.
        oids = [ObjectID.for_task_return(spec.task_id, i)
                for i in range(spec.num_returns)]
        self.refcounter.add_many(oids)
        refs = [ObjectRef(oid, owner=self.worker_id, _add_ref=False)
                for oid in oids]
        with self._lineage_lock:
            for ref in refs:
                self._lineage[ref.id] = spec
        gen = None
        if spec.generator:
            gen = ObjectRefGenerator(spec.task_id)
            self._generators[spec.task_id] = gen
        self._emit_event(spec.task_id, spec.name, "PENDING_ARGS_AVAIL")
        self._inflight.add(spec.task_id)
        self._enqueue_after_deps(spec)
        if spec.generator:
            return gen
        return refs[0] if spec.num_returns == 1 else refs

    def _enqueue_after_deps(self, spec: TaskSpec) -> None:
        ref_args = [a for a in list(spec.args) + list(spec.kwargs.values())
                    if isinstance(a, ObjectRef)]
        if not ref_args:
            self._ready.put(spec)
            return
        with self._deps_lock:
            dep_list = [a.id for a in ref_args]
            landed = self.store.contains_many(dep_list)
            still = {d for d, here in zip(dep_list, landed) if not here}
            if not still:
                self._ready.put(spec)
                return
            self._pending_deps[spec.task_id] = (spec, still)
            for d in still:
                self._obj_waiters.setdefault(d, []).append(spec.task_id)

    def _on_object_ready(self, object_id: ObjectID) -> None:
        to_ready = []
        with self._deps_lock:
            for task_id in self._obj_waiters.pop(object_id, []):
                entry = self._pending_deps.get(task_id)
                if entry is None:
                    continue
                spec, deps = entry
                deps.discard(object_id)
                if not deps:
                    del self._pending_deps[task_id]
                    to_ready.append(spec)
        for spec in to_ready:
            self._ready.put(spec)

    def _resubmit(self, spec: TaskSpec) -> None:
        spec.attempt += 1
        self._emit_event(spec.task_id, spec.name, "RESUBMITTED", attempt=spec.attempt)
        self._inflight.add(spec.task_id)
        if spec.actor_id is not None:
            state = self._actors.get(spec.actor_id)
            if state is not None and state.state != _ActorState.DEAD:
                state.mailbox.put(spec)
                return
            self._fail_task(spec, ActorDiedError("actor gone; cannot reconstruct"))
            return
        self._enqueue_after_deps(spec)

    # -------------------------------------------------------------- dispatch
    def _notify_resources_freed(self) -> None:
        """Scheduler release hook: wake the dispatcher to retry blocked
        tasks. Coalesced: at most one retry token is queued at a time."""
        if self._blocked_count and not self._retry_pending:
            self._retry_pending = True
            self._ready.put(_RETRY_BLOCKED)

    @staticmethod
    def _placement_shape(spec: TaskSpec) -> tuple:
        """Bucket key under which blocked specs are interchangeable: the
        same resource demand under the same placement, however many
        strategy objects name it: the default or SPREAD, one bundle of a
        placement group (-1: the group's first bundle with room), one node
        (hard or soft), or one set of labels."""
        strat = spec.strategy
        res = tuple(sorted(spec.resources.items()))
        if strat is None:
            return (res, "DEFAULT")
        if isinstance(strat, SpreadStrategy):
            return (res, "SPREAD")
        if hasattr(strat, "placement_group"):
            return (res, strat.placement_group.id, strat.bundle_index)
        if hasattr(strat, "node_id"):
            return (res, str(strat.node_id), strat.soft)
        return (res, tuple(sorted(strat.hard.items())),
                tuple(sorted(strat.soft.items())))

    def _dispatch_loop(self) -> None:
        # Blocked tasks live in per-placement-shape FIFO queues: a capacity
        # event probes one head per shape instead of rescanning every
        # blocked spec.
        blocked: Dict[tuple, deque] = {}
        blocked_n = 0

        def retry_blocked() -> None:
            nonlocal blocked_n
            for key in list(blocked):
                q = blocked.get(key)
                while q:
                    if self._try_dispatch(q[0]):
                        q.popleft()
                        blocked_n -= 1
                    else:
                        break  # shape doesn't fit now; next bucket
                if not q:
                    blocked.pop(key, None)
            self._blocked_count = blocked_n

        while not self._dispatcher_stop.is_set():
            try:
                spec = self._ready.get(timeout=0.2)
            except queue.Empty:
                # Safety net for release notifications racing the flag.
                if blocked:
                    retry_blocked()
                continue
            if spec is None:
                break
            if spec is _RETRY_BLOCKED:
                self._retry_pending = False
                retry_blocked()
                continue
            key = self._placement_shape(spec)
            q = blocked.get(key)
            if q:
                # FIFO fairness: same-shape work already waits.
                q.append(spec)
                blocked_n += 1
                self._blocked_count = blocked_n
            elif not self._try_dispatch(spec):
                blocked.setdefault(key, deque()).append(spec)
                blocked_n += 1
                self._blocked_count = blocked_n

    def _try_dispatch(self, spec: TaskSpec) -> bool:
        if spec.task_id in self._cancelled:
            self.scheduler.clear_task_demand(spec.task_id)
            self._fail_task(spec, TaskCancelledError(str(spec.task_id)))
            return True
        lease = self.scheduler.try_acquire(spec.resources, spec.strategy)
        if lease is None:
            # Infeasible requests fail fast instead of hanging forever.
            if not self.scheduler.feasible(spec.resources, spec.strategy):
                self.scheduler.clear_task_demand(spec.task_id)
                in_group = hasattr(spec.strategy, "placement_group")
                self._fail_task(
                    spec,
                    InfeasibleError(
                        f"Task {spec.name} requests {spec.resources} which "
                        + ("its placement group (removed, or no bundle that "
                           "large) can never" if in_group
                           else "no node can ever")
                        + " satisfy (cluster total: "
                        f"{self.scheduler.cluster_resources()})"
                    ))
                return True
            # Blocked: visible to the autoscaler as unmet demand.
            self.scheduler.report_task_demand(spec.task_id, spec.resources)
            return False
        self.scheduler.clear_task_demand(spec.task_id)
        self._emit_event(spec.task_id, spec.name, "SUBMITTED_TO_WORKER",
                         node_id=str(lease.node_id))
        try:
            self._exec_pool.submit(self._execute_task, spec, lease)
        except RuntimeError:
            self.scheduler.release(lease)
            self._fail_task(spec, WorkerCrashedError("runtime is shutting down"))
        return True

    # -------------------------------------------------------------- execution
    def _execute_task(self, spec: TaskSpec, lease: Lease) -> None:
        ctx = TaskContext(spec.task_id, spec.actor_id, lease, lease.gpu_ids)
        self._running[spec.task_id] = ctx
        self._running_specs[spec.task_id] = spec
        _task_ctx.ctx = ctx
        self._emit_event(spec.task_id, spec.name, "RUNNING")
        try:
            with tracing.task_execute_span(spec):
                args, kwargs = self._resolve_args(spec)
                if spec.isolation == "process" or spec.runtime_env:
                    # A runtime env implies the process tier: envs are
                    # per-worker-process state (ref: worker_pool.h
                    # env-keyed workers).
                    if spec.generator:
                        self._run_generator_in_process(
                            spec, args, kwargs, lease.gpu_ids)
                        result = None
                    else:
                        result = self._run_in_process(
                            spec, args, kwargs, lease.gpu_ids)
                elif spec.generator:
                    self._run_generator(spec, args, kwargs)
                    result = None
                else:
                    result = spec.func(*args, **kwargs)
            if ctx.node_lost:
                return  # failed over when its node died
            if spec.task_id in self._cancelled:
                raise TaskCancelledError(str(spec.task_id))
            if not spec.generator:
                self._store_results(spec, result)
            self._emit_event(spec.task_id, spec.name, "FINISHED")
        except BaseException as e:  # noqa: BLE001 — stored as the task's result
            if not ctx.node_lost:
                self._handle_task_failure(spec, e)
        finally:
            _task_ctx.ctx = None
            # A retry after the node's loss runs under the same task id.
            if self._running.get(spec.task_id) is ctx:
                self._running.pop(spec.task_id, None)
                self._running_specs.pop(spec.task_id, None)
            self.scheduler.release(lease)

    def _resolve_ref(self, v: Any) -> Any:
        if not isinstance(v, ObjectRef):
            return v
        return self._get_one(v, None)

    def _resolve_args(self, spec: TaskSpec):
        args = tuple(self._resolve_ref(a) for a in spec.args)
        kwargs = {k: self._resolve_ref(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def _lease_env_worker(self, runtime_env, gpu_ids):
        """Stage a runtime env (if any) and lease a process worker of that
        env that sees the cards ``gpu_ids``."""
        env_key, env_payload = "", None
        if runtime_env:
            from ray_tpu_torch._private.runtime_env import (RuntimeEnv,
                                                            payload_key)

            env_payload = RuntimeEnv.normalize(runtime_env).stage()
            env_key = payload_key(env_payload)
        return self.process_pool.lease(env_key, env_payload, gpu_ids)

    @staticmethod
    def _fn_id(fn) -> str:
        return getattr(fn, "__qualname__", "fn") + ":" + str(id(fn))

    def _run_in_process(self, spec: TaskSpec, args, kwargs, gpu_ids):
        worker = self._lease_env_worker(spec.runtime_env, gpu_ids)
        self._track_leased_worker(worker)
        try:
            result = _WireForm(worker.execute(
                self._fn_id(spec.func), spec.func, args, kwargs, raw=True))
        except (TaskError, WorkerCrashedError):
            self.process_pool.discard(worker)
            raise
        finally:
            self._untrack_leased_worker(worker)
        self.process_pool.release(worker)
        return result

    def _run_generator_in_process(self, spec: TaskSpec, args, kwargs,
                                  gpu_ids) -> None:
        """A streaming generator task on a leased process worker: items
        arrive over the multiplexed pipe and feed the ordinary generator
        machinery, so the items yielded before an error outlive it."""
        worker = self._lease_env_worker(spec.runtime_env, gpu_ids)
        self._track_leased_worker(worker)
        ok = False
        try:
            self._run_generator(
                spec, args, kwargs, iterator=worker.execute_gen(
                    self._fn_id(spec.func), spec.func, args, kwargs))
            ok = True
        finally:
            self._untrack_leased_worker(worker)
            if ok:
                self.process_pool.release(worker)
            else:
                self.process_pool.discard(worker)

    def _run_generator(self, spec: TaskSpec, args, kwargs,
                       iterator=None) -> None:
        gen_handle = self._generators.get(spec.task_id)
        index = 0
        if iterator is None:
            iterator = spec.func(*args, **kwargs)
        try:
            for value in iterator:
                if spec.task_id in self._cancelled:
                    raise TaskCancelledError(str(spec.task_id))
                object_id = ObjectID.for_task_return(spec.task_id, index)
                self.store.put(object_id, value)
                self._on_object_ready(object_id)
                if gen_handle is not None:
                    gen_handle._push(ObjectRef(object_id, owner=self.worker_id))
                index += 1
            if gen_handle is not None:
                gen_handle._finish()
            self._inflight.discard(spec.task_id)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            if gen_handle is not None:
                gen_handle._finish(TaskError(e, task_repr=spec.name))
            raise
        finally:
            self._generators.pop(spec.task_id, None)

    def _store_results(self, spec: TaskSpec, result: Any) -> None:
        if isinstance(result, _WireForm):
            if spec.num_returns == 1:
                # A process worker's result: kept as its wire form in the
                # serialized tier, deserialized on first get.
                object_id = ObjectID.for_task_return(spec.task_id, 0)
                self.store.put_serialized(object_id, result.flat)
                self._on_object_ready(object_id)
                self._inflight.discard(spec.task_id)
                return
            result = result.value()
        if spec.num_returns == 1:
            outputs = [result]
        else:
            if not isinstance(result, (tuple, list)) or len(result) != spec.num_returns:
                raise ValueError(
                    f"Task {spec.name} declared num_returns={spec.num_returns} but "
                    f"returned {type(result)}")
            outputs = list(result)
        for i, value in enumerate(outputs):
            object_id = ObjectID.for_task_return(spec.task_id, i)
            self.store.put(object_id, value)
            self._on_object_ready(object_id)
        self._inflight.discard(spec.task_id)

    def _handle_task_failure(self, spec: TaskSpec, error: BaseException) -> None:
        is_app_error = not isinstance(
            error, (WorkerCrashedError, SystemError, MemoryError, ObjectLostError))
        if spec.generator:
            # Streaming tasks never retry mid-stream: the consumer already
            # holds items (and the error).
            self._fail_task(spec, error)
            return
        retryable = (not is_app_error) or spec.retry_exceptions
        if isinstance(error, TaskCancelledError):
            retryable = False
        if retryable and spec.attempt < spec.max_retries:
            spec.attempt += 1
            self._emit_event(spec.task_id, spec.name, "RETRYING", attempt=spec.attempt)
            self._enqueue_after_deps(spec)
            return
        self._fail_task(spec, error)

    def _fail_task(self, spec: TaskSpec, error: BaseException) -> None:
        if not isinstance(error, (TaskError, TaskCancelledError, ActorDiedError)):
            error = TaskError(error, task_repr=spec.name)
        for i in range(max(spec.num_returns, 1)):
            object_id = ObjectID.for_task_return(spec.task_id, i)
            if spec.generator and self.store.contains(object_id):
                continue  # an item the generator yielded outlives its failure
            self.store.put_error(object_id, error)
            self._on_object_ready(object_id)
        gen_handle = self._generators.pop(spec.task_id, None)
        if gen_handle is not None:
            gen_handle._finish(error)
        self._inflight.discard(spec.task_id)
        self._emit_event(spec.task_id, spec.name, "FAILED", error=repr(error))

    # ---------------------------------------------------------------- cancel
    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        task_id = ref.id.task_id()
        self._cancelled.add(task_id)
        ctx = self._running.get(task_id)
        if ctx is not None:
            ctx.cancelled.set()
        else:
            with self._deps_lock:
                entry = self._pending_deps.pop(task_id, None)
            if entry is not None:
                self._fail_task(entry[0], TaskCancelledError(str(task_id)))

    # ---------------------------------------------------------------- lineage
    def _lineage_for(self, object_id: ObjectID) -> Optional[TaskSpec]:
        with self._lineage_lock:
            return self._lineage.get(object_id)

    def _on_zero_refs(self, object_id: ObjectID) -> None:
        self.store.free(object_id)
        with self._lineage_lock:
            self._lineage.pop(object_id, None)

    # ----------------------------------------------------------------- actors
    def create_actor(self, spec: ActorSpec) -> None:
        state = _ActorState(spec)
        with self._actors_lock:
            if spec.name:
                key = (spec.namespace, spec.name)
                if key in self._named_actors:
                    existing = self._actors.get(self._named_actors[key])
                    if existing is not None and existing.state != _ActorState.DEAD:
                        raise ValueError(f"Actor name '{spec.name}' already taken")
                self._named_actors[key] = spec.actor_id
            self._actors[spec.actor_id] = state
        try:
            self._exec_pool.submit(self._start_actor, state, first=True)
        except RuntimeError:
            state.death_cause = ActorDiedError("runtime is shutting down")
            state.state = _ActorState.DEAD
            state.ready_event.set()

    def _start_actor(self, state: _ActorState, first: bool) -> None:
        spec = state.spec
        try:
            lease = self.scheduler.acquire(spec.resources,
                                           strategy=spec.strategy)
        except BaseException as e:  # noqa: BLE001 — the actor's death cause
            state.death_cause = e
            state.state = _ActorState.DEAD
            state.ready_event.set()
            self._drain_mailbox(state)
            return
        state.lease = lease
        state.node_id = lease.node_id
        try:
            args, kwargs = self._resolve_values(spec.args, spec.kwargs)
            if spec.isolation == "process" or spec.runtime_env:
                # A dedicated worker process hosts the instance (the
                # reference's default: one worker process per actor).
                worker = self._lease_env_worker(spec.runtime_env,
                                                lease.gpu_ids)
                try:
                    worker.actor_new(serialization.dumps(spec.cls),
                                     spec.actor_id, args, kwargs)
                except BaseException:
                    self.process_pool.discard(worker)
                    raise
                state.proc_worker = worker
            else:
                # __init__ runs with an actor-scoped context so code inside
                # it can see the actor identity.
                _task_ctx.ctx = TaskContext(TaskID.from_random(),
                                            spec.actor_id,
                                            gpu_ids=lease.gpu_ids)
                try:
                    state.instance = spec.cls(*args, **kwargs)
                finally:
                    _task_ctx.ctx = None
        except BaseException as e:  # noqa: BLE001 — the actor's death cause
            self.scheduler.release(lease)
            state.lease = None
            state.death_cause = TaskError(e, task_repr=f"{spec.cls.__name__}.__init__")
            state.state = _ActorState.DEAD
            state.ready_event.set()
            self._drain_mailbox(state)
            return
        state.state = _ActorState.ALIVE
        state.ready_event.set()
        if first or not state.threads:
            self._start_actor_executors(state)

    def _resolve_values(self, args, kwargs):
        return (tuple(self._resolve_ref(a) for a in args),
                {k: self._resolve_ref(v) for k, v in kwargs.items()})

    def _start_actor_executors(self, state: _ActorState) -> None:
        if state.is_async:
            t = threading.Thread(target=self._actor_async_loop, args=(state,), daemon=True)
            t.start()
            state.threads = [t]
        else:
            n = max(1, state.spec.max_concurrency)
            state.threads = []
            for _ in range(n):
                t = threading.Thread(target=self._actor_sync_loop, args=(state,), daemon=True)
                t.start()
                state.threads.append(t)

    def _actor_sync_loop(self, state: _ActorState) -> None:
        while True:
            item = state.mailbox.get()
            if item is None:
                return
            spec: TaskSpec = item
            if state.state in (_ActorState.RESTARTING, _ActorState.PENDING):
                # Wait out a restart instead of calling into a torn-down
                # instance (ready_event is set on ALIVE or DEAD).
                state.ready_event.wait(timeout=300)
            if state.state != _ActorState.ALIVE:
                self._fail_task(spec, ActorDiedError(cause=state.death_cause))
                continue
            self._execute_actor_task(state, spec)

    def _actor_async_loop(self, state: _ActorState) -> None:
        loop = asyncio.new_event_loop()
        sem = asyncio.Semaphore(max(1, state.spec.max_concurrency))
        running: set = set()

        async def run_one(spec: TaskSpec):
            try:
                async with sem:
                    await self._execute_actor_task_async(state, spec)
            except asyncio.CancelledError:
                # Cancelled while still queued on the semaphore: the
                # executor never saw this call, so resolve its refs here.
                self._fail_task(spec, ActorDiedError(cause=state.death_cause))
                raise

        async def pump():
            while True:
                item = await loop.run_in_executor(None, state.mailbox.get)
                if item is None:
                    return
                if state.state in (_ActorState.RESTARTING, _ActorState.PENDING):
                    await loop.run_in_executor(
                        None, state.ready_event.wait, 300)
                if state.state != _ActorState.ALIVE:
                    self._fail_task(item, ActorDiedError(cause=state.death_cause))
                    continue
                task = loop.create_task(run_one(item))
                running.add(task)
                task.add_done_callback(running.discard)

        try:
            loop.run_until_complete(pump())
            # The actor is dead (pump returns only on the death sentinel):
            # cancel the calls still executing so each fails over to
            # ActorDiedError instead of leaving its caller hanging.
            pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
        finally:
            loop.close()

    def _execute_actor_task(self, state: _ActorState, spec: TaskSpec) -> None:
        ctx = TaskContext(spec.task_id, spec.actor_id,
                          gpu_ids=state.lease.gpu_ids if state.lease else ())
        self._running[spec.task_id] = ctx
        _task_ctx.ctx = ctx
        self._emit_event(spec.task_id, spec.name, "RUNNING")
        worker = state.proc_worker
        try:
            with tracing.task_execute_span(spec):
                args, kwargs = self._resolve_args(spec)
                if worker is not None:
                    if spec.generator:
                        # The method's items stream over the worker's pipe
                        # into the generator machinery.
                        self._run_generator(
                            spec, args, kwargs,
                            iterator=worker.actor_call_gen(
                                spec.method_name, args, kwargs))
                        result = None
                    else:
                        result = _WireForm(worker.actor_call(
                            spec.method_name, args, kwargs, raw=True))
                elif spec.generator:
                    method = getattr(state.instance, spec.method_name)
                    saved, spec.func = spec.func, method
                    try:
                        self._run_generator(spec, args, kwargs)
                    finally:
                        spec.func = saved
                    result = None
                else:
                    method = getattr(state.instance, spec.method_name)
                    result = method(*args, **kwargs)
            if not spec.generator:
                self._store_results(spec, result)
            self._emit_event(spec.task_id, spec.name, "FINISHED")
        except _ActorExit:
            self._store_results(spec, None)
            self._kill_actor_state(state, ActorDiedError("exit_actor() was called"), no_restart=True)
        except WorkerCrashedError as e:
            # The actor's process died: fail this call and run the restart
            # FSM (ref: gcs_actor_manager.h restart on worker death). Only
            # the thread whose crash matches the current worker restarts
            # it: with max_concurrency > 1, the other calls that saw the
            # same crash must not discard the restarted worker.
            self._fail_task(spec, ActorDiedError(cause=e))
            if state.proc_worker is worker:
                self._kill_actor_state(
                    state, ActorDiedError(f"actor worker process died: {e}"),
                    no_restart=False)
        except BaseException as e:  # noqa: BLE001 — stored as the call's result
            self._fail_task(spec, TaskError(e, task_repr=spec.name))
        finally:
            _task_ctx.ctx = None
            self._running.pop(spec.task_id, None)

    async def _execute_actor_task_async(self, state: _ActorState, spec: TaskSpec) -> None:
        self._emit_event(spec.task_id, spec.name, "RUNNING")
        try:
            with tracing.task_execute_span(spec):
                args, kwargs = self._resolve_args(spec)
                method = getattr(state.instance, spec.method_name)
                result = method(*args, **kwargs)
                if inspect.isawaitable(result):
                    result = await result
            self._store_results(spec, result)
            self._emit_event(spec.task_id, spec.name, "FINISHED")
        except _ActorExit:
            self._store_results(spec, None)
            self._kill_actor_state(state, ActorDiedError("exit_actor() was called"), no_restart=True)
        except asyncio.CancelledError:
            # The actor died with this call in flight: resolve the refs with
            # the death cause (callers treat ActorDiedError as retryable).
            self._fail_task(spec, ActorDiedError(cause=state.death_cause))
        except BaseException as e:  # noqa: BLE001 — stored as the call's result
            self._fail_task(spec, TaskError(e, task_repr=spec.name))

    def submit_actor_task(self, actor_id: ActorID, spec: TaskSpec) -> Any:
        if tracing.is_tracing_enabled():
            with tracing.span(f"submit::{spec.name}",
                              attributes={"task_id": spec.task_id,
                                          "actor_id": actor_id}):
                tracing.inject_task_spec(spec)
                return self._submit_actor_task_inner(actor_id, spec)
        return self._submit_actor_task_inner(actor_id, spec)

    def _submit_actor_task_inner(self, actor_id: ActorID, spec: TaskSpec) -> Any:
        state = self._actors.get(actor_id)
        if state is None:
            raise ActorDiedError(f"Unknown actor {actor_id}")
        if state.state == _ActorState.DEAD:
            ref = ObjectRef(ObjectID.for_task_return(spec.task_id, 0), owner=self.worker_id)
            self._fail_task(spec, ActorDiedError(cause=state.death_cause))
            return ref
        refs = [
            ObjectRef(ObjectID.for_task_return(spec.task_id, i), owner=self.worker_id)
            for i in range(spec.num_returns)
        ]
        gen = None
        if spec.generator:
            gen = ObjectRefGenerator(spec.task_id)
            self._generators[spec.task_id] = gen
        self._emit_event(spec.task_id, spec.name, "PENDING_ACTOR_TASK")
        self._inflight.add(spec.task_id)
        state.mailbox.put(spec)
        if spec.generator:
            return gen
        return refs[0] if spec.num_returns == 1 else refs

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        state = self._actors.get(actor_id)
        if state is None:
            return
        self._kill_actor_state(state, ActorDiedError("ray_tpu_torch.kill() was called"), no_restart)

    def _kill_actor_state(self, state: _ActorState, cause: ActorDiedError, no_restart: bool) -> None:
        with state.lock:
            spec = state.spec
            can_restart = (not no_restart) and (
                spec.max_restarts == -1 or state.num_restarts < spec.max_restarts
            )
            if state.lease is not None:
                self.scheduler.release(state.lease)
                state.lease = None
            state.instance = None
            if state.proc_worker is not None:
                self.process_pool.discard(state.proc_worker)
                state.proc_worker = None
            if can_restart:
                state.state = _ActorState.RESTARTING
                state.num_restarts += 1
                state.ready_event.clear()
                try:
                    self._exec_pool.submit(self._start_actor, state, first=False)
                except RuntimeError:
                    state.death_cause = ActorDiedError("runtime is shutting down")
                    state.state = _ActorState.DEAD
                    state.ready_event.set()
            else:
                state.state = _ActorState.DEAD
                state.death_cause = cause
                with self._actors_lock:
                    if spec.name and self._named_actors.get((spec.namespace, spec.name)) == spec.actor_id:
                        del self._named_actors[(spec.namespace, spec.name)]
                for _ in state.threads:
                    state.mailbox.put(None)

    def _drain_mailbox(self, state: _ActorState) -> None:
        while True:
            try:
                spec = state.mailbox.get_nowait()
            except queue.Empty:
                return
            if spec is not None:
                self._fail_task(spec, ActorDiedError(cause=state.death_cause))

    def get_actor_state(self, actor_id: ActorID) -> Optional[_ActorState]:
        return self._actors.get(actor_id)

    def list_actor_states(self) -> List[dict]:
        with self._actors_lock:
            return [
                {
                    "actor_id": str(aid),
                    "class_name": st.spec.cls.__name__,
                    "state": st.state,
                    "name": st.spec.name or "",
                    "num_restarts": st.num_restarts,
                }
                for aid, st in self._actors.items()
            ]

    def get_named_actor(self, name: str, namespace: Optional[str] = None) -> ActorID:
        key = (namespace or self.namespace, name)
        with self._actors_lock:
            actor_id = self._named_actors.get(key)
        if actor_id is None:
            raise ValueError(f"Failed to look up actor '{name}' in namespace '{key[0]}'")
        return actor_id

    # --------------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        self._dispatcher_stop.set()
        self._ready.put(None)
        with self._actors_lock:
            actors = list(self._actors.values())
        for state in actors:
            state.state = _ActorState.DEAD
            # Cleared first: a call that sees its worker die below must not
            # restart the actor.
            state.proc_worker = None
            for _ in state.threads or [None]:
                state.mailbox.put(None)
        # Every worker process ends and is reaped before the runtime does.
        self.process_pool.shutdown()
        stop_log_monitor()
        # Give the actors' threads a moment to take their sentinel and end
        # (a method still running is not waited for past the deadline).
        deadline = time.monotonic() + _SHUTDOWN_JOIN_S
        me = threading.current_thread()
        for state in actors:
            for t in state.threads:
                if t is not me:
                    t.join(max(0.0, deadline - time.monotonic()))
        self._exec_pool.shutdown()
        self.store.shutdown()
        self.refcounter.clear()


class _ActorExit(BaseException):
    """Raised by exit_actor() to terminate the current actor."""


class _WireForm:
    """A process worker's result as it came, in wire form."""

    __slots__ = ("flat",)

    def __init__(self, flat):
        self.flat = flat

    def value(self) -> Any:
        return serialization.deserialize_flat(memoryview(self.flat))


def _default_memory_bytes() -> int:
    """30% of the host's RAM, the reference's default object store size."""
    try:
        return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") * 0.3)
    except (ValueError, OSError, AttributeError):
        return 2 << 30


def get_runtime() -> Runtime:
    if _runtime is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _runtime


def runtime_or_none() -> Optional[Runtime]:
    return _runtime


def install_runtime(rt) -> None:
    """Install a runtime implementation (process workers install their
    ClientRuntime proxy here, so the whole API works in the child)."""
    global _runtime
    with _runtime_lock:
        _runtime = rt


def init_runtime(**kwargs) -> Runtime:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = Runtime(**kwargs)
        return _runtime


def shutdown_runtime() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None
