"""Compiled steady-state serve route — dispatch lowered onto typed channels
(the counterpart of ``ray_tpu/serve/compiled_router.py``).

The dynamic router submits one actor TaskSpec per request, so once a
deployment's replica set is STABLE the router lowers its dispatch into a
compiled graph (ref: the reference's experimental_compile layer — compiled
DAGs over python/ray/experimental/channel/, the substrate vLLM-style serving
rides):

- per RUNNING thread-tier replica, a pre-resolved pair of in-process typed
  channels (``dag/channel.py``) with a ring of reusable pre-sized request
  slots — no TaskSpec, no ObjectRef, no per-send allocation;
- a resident per-replica loop thread that drains the request channel,
  FUSES the ``@serve.batch`` micro-batch queue into the drain (the channel
  backlog IS the batch; the undecorated inner function is invoked directly
  via ``batching.batch_fusion``), executes, and writes one batched response
  message;
- a per-replica demux thread that fans results back to the callers'
  futures, keeps the router's queue accounting exact, and exports the
  router/replica spans with ONE ``record_span_batch`` call per iteration —
  admission -> batch -> execute -> demux is pure channel traffic.

Multi-stage pipelines (:class:`ServePipeline`) ride the same substrate:
stage i's demux forwards each result over a typed ``DeviceChannel`` edge
straight into stage i+1's request channels, so a prefill→decode→postprocess
request traverses the whole chain as channel traffic — no TaskSpec, no
ObjectRef, no dynamic dispatch between stages.  A ``torch.Tensor`` result
crosses the edge onto the next stage's device (none moves when both stages
share it), ordered across CUDA streams by the channel's event.

A lane's loop thread runs the replica's CUDA work on the card the replica's
lease names, under the replica's task context (``get_gpu_ids()`` answers
as in an actor call).  Process-tier replicas keep the dynamic route: their
lanes need the reference's shared-memory channels, which are not ported yet
(ROADMAP.md, Queue 1 item 11b-2).

Degradation is reconciler-driven and safe by construction: any replica
membership change observed through the long-poll push tears the graph
down within that callback (requests still buffered in the channels are
re-dispatched through the dynamic path — zero caller-visible errors), and
the route recompiles once the set has been stable for
``RAY_TPU_SERVE_COMPILED_STABLE_S``.  A replica death is also detected
locally (the loop polls its actor state between reads), so fallback does
not wait for the controller's health probe.  Pipelines subscribe to their
stages' teardowns: any stage change closes the inter-stage edges and each
hop independently degrades to the dynamic path.  ``RAY_TPU_SERVE_COMPILED
=0`` disables compilation process-wide; ``@serve.deployment(compiled_route
=False)`` disables it per deployment.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import (Channel, ChannelClosed, ChannelTimeout,
                                 DeviceChannel)
from ray_tpu_torch.util import flight_recorder as _flight_recorder
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util import watchdog as _watchdog

COMPILED_MODE_GAUGE = _metrics.Gauge(
    "ray_tpu_serve_compiled_mode",
    "1 while this router serves the deployment over the compiled channel "
    "path, 0 while it is on the dynamic fallback",
    tag_keys=("deployment",))
RECOMPILES_TOTAL = _metrics.Counter(
    "ray_tpu_serve_compiled_recompiles_total",
    "Compiled-route graph builds by this router (the first compile after "
    "deploy counts as one), by the membership-change reason that forced "
    "the rebuild (deploy / replica_death / drain / rolling_update / "
    "autoscale)",
    tag_keys=("deployment", "reason"))
FALLBACK_SECONDS = _metrics.Counter(
    "ray_tpu_serve_compiled_fallback_seconds_total",
    "Cumulative seconds this router spent on the dynamic path while "
    "compilation was desired (startup and teardown->recompile windows)",
    tag_keys=("deployment",))
PIPELINE_FORWARDS = _metrics.Counter(
    "ray_tpu_serve_pipeline_forwards_total",
    "Stage-to-stage forwards executed by multi-stage serve pipelines (a "
    "request crossing one inter-stage edge counts once)",
    tag_keys=("pipeline",))

#: Request-slot layout (one reusable pre-sized list per in-flight request,
#: pooled by the request channel's slot ring — see Channel.acquire_slot).
#: S_NEXT carries a pipeline continuation (_StageCont) or None: the demux
#: forwards the result to the next stage instead of resolving the caller.
(S_METHOD, S_ARGS, S_KWARGS, S_MUX, S_CTX, S_T0, S_RESP, S_OK, S_VALUE,
 S_NEXT) = range(10)
SLOT_WIDTH = 10

#: How long the loop blocks per read — doubles as the replica-death poll
#: interval, bounding local fallback detection.
_LOOP_TICK_S = 0.05

#: Shared sentinel context for requests submitted with tracing enabled but
#: no enclosing span: record_span_batch skips None parents, while an empty
#: dict yields a fresh root trace (parent.get() finds nothing).  One shared
#: instance — never mutated — so the hot path allocates nothing.
_ROOTLESS_CTX: dict = {}


def _env_on() -> bool:
    return os.environ.get("RAY_TPU_SERVE_COMPILED", "1").lower() not in (
        "0", "false", "no", "off")


def _stable_window_s() -> float:
    try:
        return float(os.environ.get("RAY_TPU_SERVE_COMPILED_STABLE_S", "0.5"))
    except ValueError:
        return 0.5


class _NotCompilable(Exception):
    """This replica set cannot be lowered (process tier, no live in-process
    instance, ...) — stay on the dynamic path."""


class CompiledResponse:
    """Future-like result of a compiled-route dispatch.

    Duck-types DeploymentResponse's consumer surface (``result(timeout_s)``,
    awaitable) without an ObjectRef: the value crosses one in-process
    channel, so the future is a raw-lock latch plus waiter callbacks —
    one lock allocation per request instead of an Event's lock+condition
    pair, and a lock-free resolve/result fast path (this object is built
    once per request on the hot path, so its weight shows up directly in
    dispatch cost).  Error surface matches the dynamic path — user
    exceptions arrive wrapped in TaskError, and a downstream
    BackPressureError cause is unwrapped exactly like
    DeploymentResponse.result does."""

    __slots__ = ("_latch", "_done", "_value", "_exc", "_waiters")

    def __init__(self):
        latch = threading.Lock()
        latch.acquire()
        self._latch = latch
        self._done = False
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._waiters: Optional[list] = None

    def _resolve(self, value: Any, exc: Optional[BaseException]) -> None:
        # First resolution wins (teardown races re-dispatch): a given
        # request is only ever owned by ONE resolver — the lane demux OR
        # the teardown re-dispatcher, never both — so the flag check plus
        # the latch's own release-once semantics are sufficient.
        if self._done:
            return
        self._value = value
        self._exc = exc
        self._done = True
        try:
            self._latch.release()
        except RuntimeError:
            return  # lost a (theoretically impossible) resolve race
        w = self._waiters
        if w:
            while w:
                try:
                    wake = w.pop()
                except IndexError:
                    break
                try:
                    wake()
                except Exception:
                    pass

    def _add_waiter(self, wake) -> bool:
        if self._done:
            return False
        w = self._waiters
        if w is None:
            w = self._waiters = []
        w.append(wake)
        if self._done:
            # _resolve may have drained between the append and here; pull
            # the callback back out — ValueError means it was already
            # drained (and called), which is equally fine: the caller
            # treats False as "already resolved" and callbacks are
            # idempotent.
            try:
                w.remove(wake)
            except ValueError:
                pass
            return False
        return True

    def result(self, timeout_s: Optional[float] = None) -> Any:
        if not self._done:
            if not self._latch.acquire(
                    True, -1 if timeout_s is None else max(0.0, timeout_s)):
                from ray_tpu_torch.exceptions import GetTimeoutError

                raise GetTimeoutError(
                    f"compiled serve response not ready within {timeout_s}s")
            # Cascade the latch so every other thread blocked in result()
            # wakes too (a raw lock wakes a single acquirer, unlike Event).
            self._latch.release()
        exc = self._exc
        if exc is None:
            return self._value
        from ray_tpu_torch.exceptions import TaskError
        from ray_tpu_torch.serve.exceptions import BackPressureError

        if isinstance(exc, TaskError) and isinstance(
                getattr(exc, "cause", None), BackPressureError):
            raise exc.cause from None
        raise exc

    async def _await_impl(self) -> Any:
        if not self._done:
            loop = asyncio.get_running_loop()
            f = loop.create_future()

            def _complete():
                if not f.done():
                    f.set_result(None)

            if self._add_waiter(lambda: loop.call_soon_threadsafe(_complete)):
                await f
        return self.result(timeout_s=0)

    def __await__(self):
        return self._await_impl().__await__()


def _close_loop(loop) -> None:
    """Close a lane's private event loop, first cancelling what still runs
    on it (the consumer task of a ``@serve.batch`` queue that bound to it):
    a loop closed under a pending task reports the task's failure when the
    collector finds it."""
    pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for t in pending:
        t.cancel()
    if pending:
        loop.run_until_complete(asyncio.gather(*pending,
                                               return_exceptions=True))
    loop.close()


def _redispatch_one(router, rt, method: str, args: tuple, kwargs: dict,
                    mux: Optional[str], resp: CompiledResponse,
                    attempt: int, cont=None) -> None:
    """Re-assign one torn-down request through the dynamic path, with the
    same death-retry budget DeploymentResponse gives its callers.  A
    pipeline continuation (``cont``) keeps flowing: the dynamic result
    feeds the next stage instead of resolving the caller."""
    from ray_tpu_torch.exceptions import ActorDiedError

    send_kwargs = kwargs
    if mux:
        send_kwargs = dict(kwargs)
        send_kwargs["_serve_multiplexed_model_id"] = mux
    try:
        ref = router.assign_request(method, *args, **send_kwargs)
    except BaseException as e:  # noqa: BLE001 — surface to the waiting caller
        resp._resolve(None, e)
        return
    fut = rt.as_future(ref)

    def _done(f):
        exc = f.exception()
        if isinstance(exc, ActorDiedError) and attempt < 2:
            timer = threading.Timer(
                0.2 * (attempt + 1), _redispatch_one,
                args=(router, rt, method, args, kwargs, mux, resp,
                      attempt + 1, cont))
            timer.daemon = True
            timer.start()
            return
        if exc is not None:
            resp._resolve(None, exc)
        elif cont is not None:
            try:
                cont.feed(f.result(), resp, None)
            except Exception as e:  # noqa: BLE001 — caller must not hang
                resp._resolve(None, e)
        else:
            resp._resolve(f.result(), None)

    fut.add_done_callback(_done)


def _redispatch_pending(router, pending: List[tuple]) -> None:
    from ray_tpu_torch._private import runtime as _rt

    rt = _rt.get_runtime()
    for method, args, kwargs, mux, resp, cont in pending:
        _redispatch_one(router, rt, method, args, kwargs or {}, mux, resp, 0,
                        cont)


class _Lane:
    """One replica's compiled lane: request/response channel pair plus the
    resident loop and demux threads.  The loop runs in the driver process
    directly against the thread-tier replica instance — NOT through the
    actor mailbox, so control-plane calls (check_health,
    prepare_for_shutdown) never starve behind the data plane."""

    def __init__(self, graph: "_CompiledGraph", row: Dict[str, Any],
                 actor_state, instance) -> None:
        self.graph = graph
        self.rid: str = row["replica_id"]
        self.max_ongoing = max(1, int(row.get("max_ongoing_requests") or 1))
        self.state = actor_state
        self.replica = instance
        self.wrapper = instance._wrapper
        maxsize = max(64, 2 * self.max_ongoing)
        self.req = Channel(maxsize=maxsize, name=f"serve-req:{self.rid}",
                           slot_width=SLOT_WIDTH)
        self.resp = Channel(maxsize=64, name=f"serve-resp:{self.rid}")
        # Per-method caches below are touched only from the lane's loop
        # thread — no locks; the ownership annotations make the analyzer
        # flag any access that creeps into another thread.
        self._fusion: Dict[str, Any] = {}  # owned_by_thread: _run_loop
        self._expect: Dict[str, int] = {}  # owned_by_thread: _run_loop
        self._exec_tags: Dict[str, dict] = {}  # owned_by_thread: _run_loop
        self._route_attrs = {"deployment": graph.deployment_id,
                             "replica": self.rid}
        self._task_reprs: Dict[str, str] = {}  # owned_by_thread: _run_loop
        self._loop_thread = threading.Thread(
            target=self._run_loop, daemon=True,
            name=f"serve-compiled-loop-{self.rid}")
        self._demux_thread = threading.Thread(
            target=self._run_demux, daemon=True,
            name=f"serve-compiled-demux-{self.rid}")

    def start(self) -> None:
        self._loop_thread.start()
        self._demux_thread.start()

    # ------------------------------------------------------------ submission
    def submit(self, method: str, args: tuple, kwargs: dict,
               mux: Optional[str], resp: CompiledResponse, cont) -> bool:
        """Lower one request onto this lane's request channel; False means
        'use the dynamic path' (teardown raced us) — never an error."""
        scheduler = self.graph.router._scheduler
        slot = self.req.acquire_slot()
        slot[S_METHOD] = method
        slot[S_ARGS] = args
        slot[S_KWARGS] = kwargs
        slot[S_MUX] = mux
        # _ROOTLESS_CTX (not None) when tracing is on but the caller holds
        # no enclosing span: the demux then still exports a root
        # serve.compiled_route span for the request, matching the dynamic
        # path (assign_request opens serve.route unconditionally).
        slot[S_CTX] = ((_tracing.active_span() or _ROOTLESS_CTX)
                       if _tracing.is_tracing_enabled() else None)
        slot[S_T0] = time.time()
        slot[S_RESP] = resp
        slot[S_NEXT] = cont
        # Pre-send inflight accounting, mirroring Router._dispatch: the
        # demux decrements on completion; destroy() undoes it for requests
        # drained back out of a torn-down channel.
        scheduler.on_request_sent(self.rid)
        try:
            self.req.write(slot)
        except ChannelClosed:
            scheduler.on_request_done(self.rid)
            self.req.release_slot(slot)
            return False
        return True

    # ------------------------------------------------------------- teardown
    def close_req(self) -> None:
        self.req.close()

    def join_loop(self, timeout: float) -> None:
        self._loop_thread.join(timeout=timeout)

    def drain_pending(self, out: List[tuple]) -> None:
        """Pull never-executed requests back out of the closed request
        channel for dynamic re-dispatch."""
        scheduler = self.graph.router._scheduler
        for slot in self.req.read_ready(1 << 30):  # pairs_with: release_slot
            scheduler.on_request_done(self.rid)
            out.append((slot[S_METHOD], slot[S_ARGS], slot[S_KWARGS],
                        slot[S_MUX], slot[S_RESP], slot[S_NEXT]))
            # A drained slot must go back to the ring like the demux
            # path does — otherwise every drained request permanently
            # shrinks the free list and pins its args/response future.
            self.req.release_slot(slot)

    # ------------------------------------------------------------ resolution
    def _fusion_for(self, method: str):
        """(inner, cfg, is_coro) when the routed method is
        @serve.batch-wrapped (is_coro pre-resolved: iscoroutinefunction is
        too slow for the per-batch hot path)."""
        hit = self._fusion.get(method, _Lane)
        if hit is not _Lane:
            return hit
        from ray_tpu_torch.serve.batching import batch_fusion

        if self.wrapper._is_class:
            fn = getattr(type(self.wrapper._callable), method, None)
        elif method == "__call__":
            fn = self.wrapper._callable
        else:
            fn = None
        fusion = batch_fusion(fn) if fn is not None else None
        if fusion is not None:
            inner, cfg = fusion
            fusion = (inner, cfg, inspect.iscoroutinefunction(inner))
        self._fusion[method] = fusion
        return fusion

    def _exec_tags_for(self, method: str) -> dict:
        tags = self._exec_tags.get(method)
        if tags is None:
            tags = self._exec_tags[method] = {
                "deployment": self.replica.deployment_name, "method": method}
        return tags

    def _task_repr(self, method: str) -> str:
        r = self._task_reprs.get(method)
        if r is None:
            r = self._task_reprs[method] = (
                f"{type(self.replica).__name__}.handle_request")
        return r

    # ------------------------------------------------------------- loop side
    def _run_loop(self) -> None:
        """The lane's loop thread, under the replica's task context and
        with the card its lease names as its current device (the dynamic
        path runs each call so on the actor's threads)."""
        from ray_tpu_torch._private.ids import TaskID
        from ray_tpu_torch._private.runtime import TaskContext, _task_ctx
        from ray_tpu_torch.dag.compiled_dag import _leased_device

        lease = self.state.lease
        _task_ctx.ctx = TaskContext(
            TaskID.from_random(), self.state.spec.actor_id,
            gpu_ids=lease.gpu_ids if lease is not None else ())
        try:
            with _leased_device():
                loop = asyncio.new_event_loop()
                # This thread IS the lane's event loop owner: user code
                # that calls get_event_loop() between awaits must see it.
                asyncio.set_event_loop(loop)
                scratch: list = []
                beat_key = f"serve:lane:{self.rid}"
                try:
                    while True:
                        # Channel-drain liveness: the hang watchdog flags
                        # this lane if the loop thread wedges inside user
                        # code (the actor liveness poll cannot — the thread
                        # is alive).
                        _watchdog.beat(beat_key)
                        if self.state.state != "ALIVE":
                            break  # replica died: local fallback, no probe
                        try:
                            first = self.req.read(timeout=_LOOP_TICK_S)
                        except ChannelTimeout:
                            continue
                        except ChannelClosed:
                            break
                        scratch.clear()
                        scratch.append(first)
                        self._fill_batch(scratch)
                        try:
                            self._execute_batch(scratch, loop)
                        except ChannelClosed:
                            break
                finally:
                    # Close both ends: writers fall back to the dynamic
                    # path, the demux drains every buffered response (reads
                    # stay valid on a closed channel until empty) and then
                    # notifies the manager.
                    _watchdog.get_watchdog().forget(beat_key)
                    self.req.close()
                    self.resp.close()
                    _close_loop(loop)
        finally:
            _task_ctx.ctx = None

    def _fill_batch(self, batch: list) -> None:
        """Grow the drained batch.  For a batch-fused lead method this IS
        the micro-batch queue — but smarter than the dynamic _BatchQueue:
        that queue waits blind (it cannot know whether more requests are
        coming, so it trades latency via an adaptive timeout), while the
        compiled loop shares the process with its router and can read the
        scheduler's live inflight count for this replica.  It waits only
        while more requests are already in flight toward this lane, bounded
        by the method's batch_wait_timeout_s — full batches under load,
        immediate dispatch when the queue is the whole load.  Non-fused
        lead methods take whatever is already queued, bounded by the
        replica's concurrency budget."""
        method = batch[0][S_METHOD]
        fusion = self._fusion_for(method)
        if fusion is None:
            self.req.read_ready(self.max_ongoing - 1, out=batch)
            return
        cfg = fusion[1]
        max_size = int(cfg["max_batch_size"])
        if len(batch) >= max_size:
            return
        deadline = time.monotonic() + float(cfg["batch_wait_timeout_s"])
        inflight = self.graph.router._scheduler._inflight
        expect = self._expect.get(method, 0)
        while True:
            # Dirty read (dict.get under the GIL): transiently stale is
            # fine — too-high waits at most batch_wait_timeout_s (the
            # dynamic path's bound), too-low dispatches a smaller batch.
            # max() with the last executed batch size bridges the window
            # where the demux has marked the previous batch done but the
            # closed-loop callers have not resubmitted yet.
            target = min(max_size, max(expect, inflight.get(self.rid, 0)))
            n0 = len(batch)
            self.req.read_ready(max_size - n0, out=batch)
            if len(batch) >= max_size:
                break
            if len(batch) >= target and len(batch) == n0:
                break  # nothing queued, nothing expected
            if self.req.closed:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if target - len(batch) <= 2:
                # Down to the last stragglers: a condition-wait wakes
                # exactly on arrival, avoiding a trailing sleep quantum.
                try:
                    batch.append(self.req.read(timeout=remaining))
                except (ChannelTimeout, ChannelClosed):
                    break
                continue
            # Far from target: plain GIL yield instead of a condition-wait
            # per item — the stragglers are being written right now by
            # caller threads, and one short sleep costs less than dozens
            # of per-item condvar wakeups racing those writers for the
            # channel lock.
            time.sleep(0.0001)
        self._expect[method] = len(batch)

    def _execute_batch(self, batch: list, loop) -> None:
        if len(batch) == 1:
            slot = batch[0]
            self._execute_group(slot[S_METHOD], slot[S_MUX], batch, loop)
        else:
            groups: Dict[tuple, list] = {}
            for slot in batch:
                groups.setdefault((slot[S_METHOD], slot[S_MUX]),
                                  []).append(slot)
            for (method, mux), slots in groups.items():
                self._execute_group(method, mux, slots, loop)
        self.resp.write(list(batch))

    def _execute_group(self, method: str, mux: Optional[str], slots: list,
                       loop) -> None:
        from ray_tpu_torch.exceptions import TaskError
        from ray_tpu_torch.serve import context as serve_context
        from ray_tpu_torch.serve import metrics as serve_metrics
        from ray_tpu_torch.serve.replica import _invoke_sync_unary, _is_async_callable

        task_repr = self._task_repr(method)
        live = slots
        replica = self.replica
        serve_context._set_internal_replica_context(
            deployment=replica.deployment_name,
            replica_id=replica.replica_id, replica=replica)
        if mux:
            serve_context._set_request_model_id(mux)
        n = len(live)
        replica._num_ongoing += n
        whole_exc: Optional[BaseException] = None
        results: Any = None
        t_exec = time.time()
        try:
            fusion = self._fusion_for(method)
            if fusion is not None and all(
                    len(s[S_ARGS]) == 1 and not s[S_KWARGS] for s in live):
                inner, _, is_coro = fusion
                items = [s[S_ARGS][0] for s in live]
                self_arg = (self.wrapper._callable
                            if self.wrapper._is_class else None)
                call_args = (items,) if self_arg is None else (self_arg, items)
                if is_coro:
                    results = loop.run_until_complete(inner(*call_args))
                else:
                    results = inner(*call_args)
                if (not isinstance(results, (list, tuple))
                        or len(results) != n):
                    got = (f"length {len(results)}"
                           if isinstance(results, (list, tuple))
                           else type(results).__name__)
                    raise TypeError(
                        f"@serve.batch function "
                        f"{getattr(inner, '__name__', inner)!r} must return "
                        f"a list with one result per request (expected "
                        f"length {n}, got {got})")
            else:
                target = self.wrapper._target(method)
                if _is_async_callable(target):
                    # Concurrent per-request coroutines on the lane's
                    # private loop: handlers that delegate into their own
                    # @serve.batch methods still coalesce (the inner queue
                    # binds to this loop and sees the whole group at once).
                    calls = [self.wrapper.call(method, tuple(s[S_ARGS]),
                                               dict(s[S_KWARGS] or {}))
                             for s in live]

                    async def _gather():
                        return await asyncio.gather(*calls,
                                                    return_exceptions=True)

                    results = loop.run_until_complete(_gather())
                else:
                    # Sync handlers run inline — this thread IS the
                    # replica's dedicated worker, no executor hop.
                    results = []
                    for s in live:
                        try:
                            results.append(_invoke_sync_unary(
                                target, tuple(s[S_ARGS]),
                                dict(s[S_KWARGS] or {})))
                        except Exception as e:  # noqa: BLE001 — per request
                            results.append(e)
        except Exception as e:  # noqa: BLE001 — whole-group failure
            whole_exc = e
        exec_end = time.time()
        replica._num_ongoing -= n
        replica._num_processed += n
        tags = self._exec_tags_for(method)
        first_ctx = next((s[S_CTX] for s in live if s[S_CTX]), None)
        serve_metrics.EXECUTION.observe(
            exec_end - t_exec, tags=tags,
            exemplar=serve_metrics.trace_exemplar(first_ctx))
        if _tracing.is_tracing_enabled():
            # One batched export per vectorized call (satellite: tracing
            # overhead) instead of a span context manager per request.
            _tracing.record_span_batch(
                "serve.compiled_batch",
                [(t_exec, exec_end, s[S_CTX]) for s in live],
                attributes=dict(tags, replica=self.rid, batch_size=n))
        if whole_exc is not None:
            err: Any = whole_exc
            if not isinstance(err, TaskError):
                err = TaskError(err, task_repr=task_repr)
            for s in live:
                s[S_OK] = False
                s[S_VALUE] = err
            return
        for s, r in zip(live, results):
            if isinstance(r, Exception):
                s[S_OK] = False
                s[S_VALUE] = (r if isinstance(r, TaskError)
                              else TaskError(r, task_repr=task_repr))
            else:
                s[S_OK] = True
                s[S_VALUE] = r

    # ------------------------------------------------------------ demux side
    def _run_demux(self) -> None:
        from ray_tpu_torch.serve import metrics as serve_metrics

        router = self.graph.router
        scheduler = router._scheduler
        tags = router._metric_tags
        while True:
            try:
                batch = self.resp.read(timeout=0.5)
            except ChannelTimeout:
                continue
            except ChannelClosed:
                break
            now = time.time()
            # Wake callers first: everything else (latency metrics, span
            # export, slot recycling) happens while they are already
            # resubmitting, shortening the closed-loop cycle.
            errors = 0
            for slot in batch:
                if slot[S_OK]:
                    cont = slot[S_NEXT]
                    if cont is not None:
                        # Pipeline hop: the value flows to the next stage
                        # (typed edge -> its compiled lanes) instead of
                        # resolving the caller — the caller's future rides
                        # along and resolves at the LAST stage.
                        try:
                            cont.feed(slot[S_VALUE], slot[S_RESP],
                                      slot[S_CTX])
                        except Exception as e:  # noqa: BLE001 — never hang
                            slot[S_RESP]._resolve(None, e)
                    else:
                        slot[S_RESP]._resolve(slot[S_VALUE], None)
                else:
                    errors += 1
                    slot[S_RESP]._resolve(None, slot[S_VALUE])
            # One lock round-trip for the whole batch, not one per slot —
            # the callers we just woke are hitting the same scheduler lock
            # to resubmit.
            scheduler.on_request_done(self.rid, len(batch))
            spans = [] if _tracing.is_tracing_enabled() else None
            latencies = []
            first_ctx = None
            for slot in batch:
                t0 = slot[S_T0]
                ctx = slot[S_CTX]
                latencies.append(now - t0)
                if ctx is not None:
                    if first_ctx is None:
                        first_ctx = ctx
                    if spans is not None:
                        spans.append((t0, now, ctx))
                self.req.release_slot(slot)
            serve_metrics.REQUEST_LATENCY.observe_batch(
                latencies, tags=tags,
                exemplar=serve_metrics.trace_exemplar(first_ctx))
            serve_metrics.REQUESTS_TOTAL.inc(len(batch), tags=tags)
            if errors:
                serve_metrics.ERRORS_TOTAL.inc(errors, tags=tags)
            if spans:
                # Batched route-span export: one emit loop per compiled
                # iteration instead of a span per request.
                _tracing.record_span_batch("serve.compiled_route", spans,
                                           attributes=self._route_attrs)
        # resp channel closed AND drained: the lane is down (replica death
        # or teardown) — let the manager fall back / finish the teardown.
        self.graph._lane_closed(self)


class _CompiledGraph:
    """The compiled route for one (router, replica-set) pair."""

    def __init__(self, router, rows: List[Dict[str, Any]], manager) -> None:
        from ray_tpu_torch._private import runtime as _rt

        self.router = router
        self.manager = manager
        self.deployment_id = router.deployment_id
        rt = _rt.get_runtime()
        lanes: Dict[str, Any] = {}
        for row in rows:
            actor = row.get("actor")
            if actor is None:
                raise _NotCompilable(f"replica {row.get('replica_id')} "
                                     f"carries no actor handle")
            st = rt.get_actor_state(actor._actor_id)
            if st is None or st.state != "ALIVE":
                raise _NotCompilable(
                    f"replica {row['replica_id']} is not a live actor")
            if st.instance is not None:
                # Thread tier: the replica instance shares our heap — the
                # lane executes it directly on a resident driver thread.
                if not hasattr(st.instance, "_wrapper"):
                    raise _NotCompilable(
                        f"replica {row['replica_id']} is not a serve replica")
                lanes[row["replica_id"]] = _Lane(self, row, st, st.instance)
            else:
                # Process tier: a lane there needs the shared-memory
                # channels, not ported yet — the route stays dynamic.
                raise _NotCompilable(
                    f"replica {row['replica_id']} runs in a worker process; "
                    f"its lane needs the shared-memory channels (ROADMAP.md, "
                    f"Queue 1 item 11b-2)")
        if not lanes:
            raise _NotCompilable("empty replica set")
        self._lanes = lanes
        # Single-replica deployments skip the scheduler pick entirely —
        # there is exactly one place the request can go.
        self._single_lane = (next(iter(lanes.values()))
                             if len(lanes) == 1 else None)
        self._destroyed = False  # guarded_by: _destroy_lock
        self._destroy_lock = threading.Lock()
        for lane in lanes.values():
            lane.start()

    def _submit_core(self, method: str, args: tuple, kwargs: dict,
                     resp: CompiledResponse, cont) -> bool:
        router = self.router
        mux = kwargs.get("_serve_multiplexed_model_id")
        lane = self._single_lane
        if lane is None:
            # The same scheduler pick as the dynamic path (warm
            # multiplexed replicas first, then two choices), mapped to the
            # chosen replica's resident lane.
            row = router._scheduler.choose_replica(mux or None)
            if row is None:
                return False
            lane = self._lanes.get(row["replica_id"])
            if lane is None:
                return False
        if mux is not None:
            kwargs = {k: v for k, v in kwargs.items()
                      if k != "_serve_multiplexed_model_id"}
        return lane.submit(method, args, kwargs, mux, resp, cont)

    def submit(self, method: str, args: tuple,
               kwargs: dict) -> Optional[CompiledResponse]:
        """Lower one request onto a lane; None means 'use the dynamic path'
        (teardown race, unknown replica) — never an error."""
        resp = CompiledResponse()
        if self._submit_core(method, args, kwargs, resp, None):
            return resp
        return None

    def submit_forward(self, method: str, args: tuple, kwargs: dict,
                       resp: CompiledResponse, cont) -> bool:
        """Pipeline-hop entry: lower a mid-pipeline request that already
        carries its caller's future (and possibly a further continuation);
        False means 'this hop must go dynamic' — never an error."""
        return self._submit_core(method, args, kwargs, resp, cont)

    def _lane_closed(self, lane) -> None:
        self.manager._graph_broken(self, lane.rid)

    def destroy(self) -> None:
        """Tear the graph down: close the request channels (writers fall
        back to dynamic dispatch immediately), join the loop threads, then
        re-dispatch every request still buffered through the dynamic path
        on a detached thread — callers blocked in result() never see the
        teardown.  Idempotent; demux threads are NOT joined (they drain the
        remaining responses and exit on their own)."""
        with self._destroy_lock:
            if self._destroyed:
                return
            self._destroyed = True
        for lane in self._lanes.values():
            lane.close_req()
        for lane in self._lanes.values():
            lane.join_loop(2.0)
        pending: List[tuple] = []
        for lane in self._lanes.values():
            lane.drain_pending(pending)
        if pending:
            t = threading.Thread(
                target=_redispatch_pending, args=(self.router, pending),
                daemon=True,
                name=f"serve-compiled-redispatch-{self.deployment_id}")
            t.start()


class CompiledRouteManager:
    """Per-router compiled-route state machine: dynamic -> (replica set
    stable for the window) -> compiled -> (any membership change or local
    death) -> dynamic -> ...  Driven by the router's long-poll callback
    (teardown) and its metrics tick (recompile check)."""

    def __init__(self, router) -> None:
        self._router = router
        self._dep_tags = {"deployment": router.deployment_id}
        self._lock = threading.RLock()
        self._graph: Optional[_CompiledGraph] = None
        self._rows: List[Dict[str, Any]] = []  # guarded_by: _lock
        self._sig: tuple = ()  # guarded_by: _lock
        self._uncompilable_sig: Optional[tuple] = None  # guarded_by: _lock
        self._last_change = time.monotonic()
        self._fallback_since = time.monotonic()
        self._config_enabled: Optional[bool] = None
        #: Why the NEXT compile will happen: the reason of the membership
        #: change that tore the last graph down (stamped by the reconciler
        #: onto replica rows), or "replica_death" for a locally-observed
        #: corpse.  "deploy" covers the first compile.  # guarded_by: _lock
        self._rebuild_reason = "deploy"
        self._stopped = False
        #: Pipelines subscribed to this stage's teardowns.  # guarded_by: _lock
        self._listeners: List[Any] = []
        COMPILED_MODE_GAUGE.set(0.0, tags=self._dep_tags)

    def add_teardown_listener(self, fn) -> None:
        """Register a callback fired whenever this route's compiled graph
        is detached (membership change, local death, stop) — pipelines use
        it to close their inter-stage edges so every hop degrades to the
        dynamic path together."""
        with self._lock:
            self._listeners.append(fn)

    def remove_teardown_listener(self, fn) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _notify_teardown(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn()
            except Exception:  # noqa: BLE001 — teardown must not fail
                pass

    @property
    def graph(self) -> Optional[_CompiledGraph]:
        return self._graph

    @property
    def mode(self) -> str:
        return "compiled" if self._graph is not None else "dynamic"

    def on_replica_set(self, replicas: List[Dict[str, Any]]) -> None:
        """Long-poll push: any membership change tears the compiled graph
        down within this callback — fallback inside one reconciler tick."""
        sig = tuple(sorted(r["replica_id"] for r in replicas))
        graph = None
        with self._lock:
            self._rows = list(replicas)
            if replicas:
                self._config_enabled = replicas[0].get("compiled_route")
            if sig != self._sig:
                self._sig = sig
                self._last_change = time.monotonic()
                self._uncompilable_sig = None
                if replicas:
                    self._rebuild_reason = (
                        replicas[0].get("change_reason") or "deploy")
                graph = self._detach_locked()
        if graph is not None:
            self._notify_teardown()
            graph.destroy()

    def _detach_locked(self) -> Optional[_CompiledGraph]:
        graph = self._graph
        if graph is not None:
            self._graph = None
            self._fallback_since = time.monotonic()
            COMPILED_MODE_GAUGE.set(0.0, tags=self._dep_tags)
        return graph

    def _desired(self) -> bool:
        if self._config_enabled is False:
            return False
        return _env_on()

    def maybe_compile(self) -> None:
        """Metrics-tick hook: compile when desired, stable, and lowerable."""
        if self._stopped or self._graph is not None or not self._desired():
            return
        with self._lock:
            if self._graph is not None or self._stopped or not self._rows:
                return
            if self._sig and self._sig == self._uncompilable_sig:
                return
            if time.monotonic() - self._last_change < _stable_window_s():
                return
            try:
                graph = _CompiledGraph(self._router, self._rows, self)
            except _NotCompilable:
                # Sticky until the set changes: retrying an unlowerable set
                # every tick would spin for nothing.
                self._uncompilable_sig = self._sig
                return
            self._graph = graph
            RECOMPILES_TOTAL.inc(tags={**self._dep_tags,
                                       "reason": self._rebuild_reason})
            FALLBACK_SECONDS.inc(
                max(0.0, time.monotonic() - self._fallback_since),
                tags=self._dep_tags)
            COMPILED_MODE_GAUGE.set(1.0, tags=self._dep_tags)

    def _graph_broken(self, graph: _CompiledGraph, replica_id: str) -> None:
        """A lane observed its replica die before any controller push."""
        broke = False
        with self._lock:
            if self._graph is graph:
                self._graph = None
                self._fallback_since = time.monotonic()
                # Hold recompilation until the reconciler pushes a fresh
                # set — rebuilding around the corpse would just fail.
                self._last_change = time.monotonic()
                self._rebuild_reason = "replica_death"
                COMPILED_MODE_GAUGE.set(0.0, tags=self._dep_tags)
                broke = True
        if broke:
            # Fallback forensics, outside the manager lock: the ring still
            # holds the dead replica's final compiled-batch spans.
            _flight_recorder.trigger_dump("compiled_fallback", {
                "deployment": self._dep_tags["deployment"],
                "replica": replica_id,
                "reason": "replica_death",
            })
            self._notify_teardown()
        graph.destroy()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            graph = self._detach_locked()
        if graph is not None:
            self._notify_teardown()
            graph.destroy()


class _StageCont:
    """Continuation carried in a slot's S_NEXT: 'when this stage's result
    is ready, feed it into pipeline stage ``index``' — the demux (or the
    dynamic-fallback callback) invokes it instead of resolving the
    caller."""

    __slots__ = ("pipeline", "index")

    def __init__(self, pipeline: "ServePipeline", index: int) -> None:
        self.pipeline = pipeline
        self.index = index

    def feed(self, value: Any, resp: CompiledResponse, ctx) -> None:
        self.pipeline._feed(self.index, value, resp, ctx)


class _PipelineEdge:
    """One inter-stage hop: a typed :class:`DeviceChannel` plus a feeder
    thread that submits arrivals into the downstream stage.  With a device
    assigned, the payload lands on the consumer stage's device at write
    time (``payload_index=0`` — the rider future/ctx fields stay on host).
    On close the feeder drains every buffered record (reads stay valid on
    a closed channel until empty) through ``_submit_stage``, whose dynamic
    fallback guarantees no request is dropped."""

    def __init__(self, pipeline: "ServePipeline", index: int,
                 device) -> None:
        self.pipeline = pipeline
        self.index = index  # downstream stage this edge feeds
        self.chan = DeviceChannel(
            device=device, maxsize=64,
            name=f"serve-pipe:{pipeline.name}:{index}", payload_index=0)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"serve-pipe-feed-{pipeline.name}-{index}")
        self._thread.start()

    def write(self, record: tuple) -> bool:
        """False means 'edge unusable — take the direct path'."""
        try:
            self.chan.write(record, timeout=5.0)
        except (ChannelClosed, ChannelTimeout):
            return False
        return True

    def _run(self) -> None:
        while True:
            try:
                value, resp, ctx = self.chan.read(timeout=0.5)
            except ChannelTimeout:
                continue
            except ChannelClosed:
                break  # closed AND drained
            try:
                self.pipeline._submit_stage(self.index, (value,), {}, resp)
            except Exception as e:  # noqa: BLE001 — caller must not hang
                resp._resolve(None, e)

    def close(self) -> None:
        self.chan.close()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout=timeout)


class ServePipeline:
    """A multi-stage compiled serve graph: deployment handles chained so a
    request traverses stage 0 -> 1 -> ... -> n-1 entirely as channel
    traffic.  Stage i's demux forwards each result through a typed
    DeviceChannel edge straight into stage i+1's compiled lanes (S_NEXT
    continuation); the caller's CompiledResponse rides the whole chain and
    resolves with the LAST stage's result.

    Degradation is per hop and reconciler-driven: each stage's
    CompiledRouteManager notifies the pipeline on teardown, the edges
    close, and every hop independently falls back to dynamic dispatch
    (``router.assign_request``) until the stage recompiles — callers see
    results, never errors, through a membership change.  Backpressure is
    natural: inter-stage writes block on a full edge, and the chain is
    acyclic, so there is no deadlock.

    Built via :func:`ray_tpu_torch.serve.pipeline`."""

    def __init__(self, handles: List[Any],
                 methods: Optional[List[str]] = None,
                 devices: Optional[List[Any]] = None,
                 name: str = "pipeline") -> None:
        if len(handles) < 2:
            raise ValueError("a serve pipeline needs at least two stages")
        if methods is not None and len(methods) != len(handles):
            raise ValueError("methods must match stages 1:1")
        if devices is not None and len(devices) != len(handles) - 1:
            raise ValueError("devices must match inter-stage edges 1:1 "
                             "(one fewer than stages)")
        self.name = name
        self._handles = list(handles)
        self._routers = [h._get_router() for h in handles]
        self._methods = (list(methods) if methods is not None else
                         [getattr(h, "_method_name", None) or "__call__"
                          for h in handles])
        self._devices = list(devices) if devices is not None else (
            [None] * (len(handles) - 1))
        self._fwd_tags = {"pipeline": name}
        self._lock = threading.Lock()
        #: _edges[i] feeds stage i (index 0 unused); None = direct/dynamic.
        self._edges: List[Optional[_PipelineEdge]] = [None] * len(handles)
        #: _conts[i] = what stage i's demux does with its result; the last
        #: stage has no continuation — its demux resolves the caller.
        self._conts: List[Optional[_StageCont]] = (
            [_StageCont(self, i + 1) for i in range(len(handles) - 1)]
            + [None])
        self._edges_built = False  # guarded_by: _lock
        #: Unsynchronized fast-path mirror of _edges_built: a stale read
        #: only costs taking the lock (or retrying the build on the next
        #: remote()), never a wrong edge.
        self._edges_ready = False
        self._stopped = False
        self._teardown_cbs = []
        for router in self._routers:
            cb = self._on_stage_teardown  # one shared bound method is fine
            router._compiled.add_teardown_listener(cb)
            self._teardown_cbs.append((router, cb))

    # ---------------------------------------------------------------- public
    @property
    def mode(self) -> str:
        """'compiled' when every stage currently runs its compiled route."""
        return ("compiled" if all(r._compiled.graph is not None
                                  for r in self._routers) else "dynamic")

    def remote(self, *args, **kwargs) -> CompiledResponse:
        """Submit one request to stage 0; the returned future resolves
        with the LAST stage's result."""
        if self._stopped:
            raise RuntimeError(f"pipeline {self.name!r} is stopped")
        self._maybe_build_edges()
        resp = CompiledResponse()
        self._submit_stage(0, args, kwargs, resp)
        return resp

    def stop(self) -> None:
        """Close the edges and unsubscribe from the stages (the stages'
        own routes keep running — they belong to serve, not to us)."""
        self._stopped = True
        for router, cb in self._teardown_cbs:
            router._compiled.remove_teardown_listener(cb)
        self._teardown_cbs = []
        self._close_edges()

    # ------------------------------------------------------------- internals
    def _maybe_build_edges(self) -> None:
        """Lazily (re)build the inter-stage edges once every stage is on
        its compiled route.  Cheap dirty check outside the lock — the hot
        path after build is one boolean read."""
        if self._edges_ready or self._stopped:
            return
        if any(r._compiled.graph is None for r in self._routers):
            return  # some stage still dynamic: hops stay direct
        with self._lock:
            if self._edges_built or self._stopped:
                return
            for i in range(1, len(self._handles)):
                if self._edges[i] is None:
                    self._edges[i] = _PipelineEdge(self, i,
                                                   self._devices[i - 1])
            self._edges_built = True
            self._edges_ready = True
        # A teardown may have raced the build: re-check and unwind so a
        # stale edge never outlives its stage's compiled route.
        if any(r._compiled.graph is None for r in self._routers):
            self._close_edges()

    def _on_stage_teardown(self) -> None:
        self._close_edges()

    def _close_edges(self) -> None:
        with self._lock:
            edges = [e for e in self._edges if e is not None]
            self._edges = [None] * len(self._handles)
            self._edges_built = False
            self._edges_ready = False
        for e in edges:  # pairs_with: _PipelineEdge.__init__
            e.close()  # feeder drains buffered records, then exits

    def _feed(self, index: int, value: Any, resp: CompiledResponse,
              ctx) -> None:
        """Forward a stage result into stage ``index`` (called from the
        upstream demux/fallback with the result in hand)."""
        PIPELINE_FORWARDS.inc(tags=self._fwd_tags)
        edge = self._edges[index]
        if edge is not None and edge.write((value, resp, ctx)):
            return
        self._submit_stage(index, (value,), {}, resp)

    def _submit_stage(self, index: int, args: tuple, kwargs: dict,
                      resp: CompiledResponse) -> None:
        """Lower one request into stage ``index``'s compiled lanes, or
        fall back to the dynamic path for this hop.  Either way the
        request keeps flowing — errors land in ``resp``, never raise."""
        cont = self._conts[index]
        router = self._routers[index]
        graph = router._compiled.graph
        if graph is not None:
            try:
                if graph.submit_forward(self._methods[index], args,
                                        kwargs, resp, cont):
                    return
            except Exception as e:  # noqa: BLE001 — caller must not hang
                resp._resolve(None, e)
                return
        from ray_tpu_torch._private import runtime as _rt

        try:
            rt = _rt.get_runtime()
        except Exception as e:  # noqa: BLE001 — shutdown race
            resp._resolve(None, e)
            return
        _redispatch_one(router, rt, self._methods[index], args, kwargs,
                        None, resp, 0, cont)
