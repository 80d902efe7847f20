"""Router — picks a replica per request, pow-2 queue-aware (the counterpart
of ``ray_tpu/serve/router.py``).

(ref: python/ray/serve/_private/router.py — Router:321/AsyncioRouter:340;
replica choice in replica_scheduler/pow_2_scheduler.py
PowerOfTwoChoicesReplicaScheduler:52 — sample two replicas, compare queue
lengths, pick the shorter; queue metrics are HANDLE-reported to the
controller for autoscaling (autoscaling_state.py), never probed from
replicas — a saturated replica couldn't answer the probe anyway.)

A request that carries a multiplexed model id prefers replicas that have
that model loaded (``choose_replica(model_id=)``). Once a thread-tier
replica set is stable, unary requests take the compiled steady-state route
(``compiled_router.py``) instead of one actor call each. The LLM prefix
directory is not ported yet (ROADMAP.md, Queue 1 item 13.7).
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.runtime import get_runtime, runtime_or_none
from ray_tpu_torch.serve import metrics as serve_metrics
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

INFLIGHT_GAUGE = _metrics.Gauge(
    "serve_router_inflight",
    "Requests in flight to a deployment, as observed by one router",
    tag_keys=("deployment",))
SHED_COUNTER = _metrics.Counter(
    "serve_router_shed_total",
    "Requests rejected with BackPressureError (deployment at capacity)",
    tag_keys=("deployment",))


class PowerOfTwoChoicesReplicaScheduler:
    """Locally-observed queue lengths: +1 on dispatch, -1 on completion.

    The local view is exact for a single router and approximate across many
    routers — the same trade the reference makes with its cached queue
    lengths (pow_2_scheduler queue-len cache).

    Capacity-aware: each replica entry carries its max_ongoing_requests, so
    the two-choice comparison prefers a replica with a spare slot over one
    already at capacity, and the router can tell when the WHOLE deployment
    is saturated and shed instead of queueing unboundedly.
    """

    def __init__(self) -> None:
        self._replicas: List[Dict[str, Any]] = []  # guarded_by: _lock
        self._inflight: Dict[str, int] = {}  # guarded_by: _lock
        #: Replicas this router observed dead (drop_replica) that the
        #: controller's pushes may still contain while its reconciler
        #: catches up — re-adding a corpse would let retries burn their
        #: budget re-picking it.  A tombstone clears once an update
        #: arrives without the id (replica ids are never reused).
        #: guarded_by: _lock
        self._tombstones: set = set()
        self._lock = threading.Lock()

    def update_replicas(self, replicas: List[Dict[str, Any]]) -> None:
        with self._lock:
            incoming = {r["replica_id"] for r in replicas}
            self._tombstones &= incoming
            self._replicas = [r for r in replicas
                              if r["replica_id"] not in self._tombstones]
            live = {r["replica_id"] for r in self._replicas}
            self._inflight = {rid: n for rid, n in self._inflight.items()
                              if rid in live}

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def total_inflight(self) -> int:
        with self._lock:
            return sum(self._inflight.values())

    def load(self) -> Tuple[int, int]:
        """(total inflight, total capacity) as ONE consistent snapshot."""
        with self._lock:
            inflight = sum(self._inflight.values())
            capacity = sum(int(r.get("max_ongoing_requests") or 0)
                           for r in self._replicas)
            return inflight, capacity

    def on_request_sent(self, replica_id: str) -> None:
        with self._lock:
            self._inflight[replica_id] = self._inflight.get(replica_id, 0) + 1

    def on_request_done(self, replica_id: str, n: int = 1) -> None:
        with self._lock:
            if replica_id in self._inflight:
                self._inflight[replica_id] = max(
                    0, self._inflight[replica_id] - n)

    def choose_replica(self, model_id: Optional[str] = None
                       ) -> Optional[Dict[str, Any]]:
        """Queue-aware two-choice pick; when the request carries a
        multiplexed model id, replicas that already have that model
        loaded ("warm") are preferred — but only while they have a spare
        slot, so a saturated warm set degrades to the normal queue-aware
        choice over everyone (a cold replica then loads the model) rather
        than queueing behind the warm ones (ref: the reference scheduler's
        multiplexed-model candidate ranking).  A replica with a spare slot
        beats one at or over capacity."""
        with self._lock:
            replicas = list(self._replicas)
            if not replicas:
                return None
            if model_id:
                warm = []
                for r in replicas:
                    q = self._inflight.get(r["replica_id"], 0)
                    cap = int(r.get("max_ongoing_requests") or 0)
                    if (cap <= 0 or q < cap) and model_id in (
                            r.get("multiplexed_model_ids") or ()):
                        warm.append(r)
                if len(warm) == 1:
                    return warm[0]
                if warm:
                    a, b = random.sample(warm, 2)
                    qa = self._inflight.get(a["replica_id"], 0)
                    qb = self._inflight.get(b["replica_id"], 0)
                    return a if qa <= qb else b
            if len(replicas) == 1:
                return replicas[0]
            a, b = random.sample(replicas, 2)
            qa = self._inflight.get(a["replica_id"], 0)
            qb = self._inflight.get(b["replica_id"], 0)
            ca = int(a.get("max_ongoing_requests") or 0)
            cb = int(b.get("max_ongoing_requests") or 0)
            a_spare = ca <= 0 or qa < ca
            b_spare = cb <= 0 or qb < cb
            if a_spare != b_spare:
                return a if a_spare else b
            return a if qa <= qb else b

    def drop_replica(self, replica_id: str) -> bool:
        """Remove a replica observed dead; True if any remain.  The drop
        is sticky (see _tombstones) until the controller stops pushing
        the replica."""
        with self._lock:
            self._tombstones.add(replica_id)
            self._replicas = [r for r in self._replicas
                              if r["replica_id"] != replica_id]
            return bool(self._replicas)


METRICS_PUSH_INTERVAL_S = 0.25


class Router:
    """Driver/proxy-side request router for one deployment (ref:
    router.py Router — long-poll refreshed replica set; queue metrics pushed
    to the controller for autoscaling)."""

    def __init__(self, controller_handle, deployment_id: str):
        self.deployment_id = deployment_id
        self.router_id = uuid.uuid4().hex[:8]
        self._controller = controller_handle
        self._scheduler = PowerOfTwoChoicesReplicaScheduler()
        # Per-request metric tags / span attributes are invariant per
        # (deployment, method): cached instead of rebuilt per assign.
        self._metric_tags = {"deployment": deployment_id}
        self._span_attrs: Dict[str, dict] = {}
        self._stream_span_attrs: Dict[str, dict] = {}
        self._replicas_populated = threading.Event()
        #: Deployment-level queue allowance beyond capacity; -1 = unbounded
        #: (the reference's default).  Refreshed with the replica set.
        self._max_queued_requests = -1
        #: Requests parked in _dispatch because the replica set is empty
        #: (scale-to-zero wake window).  Reported to the controller as the
        #: wake signal.  guarded_by: _wake_lock
        self._wake_waiting = 0
        self._wake_lock = threading.Lock()
        # Compiled steady-state route (built BEFORE the long-poll client:
        # its callback feeds the manager the replica set).
        from ray_tpu_torch.serve.compiled_router import CompiledRouteManager

        self._compiled = CompiledRouteManager(self)
        from ray_tpu_torch.serve.long_poll import LongPollClient

        self._long_poll = LongPollClient(
            controller_handle,
            {f"replicas::{deployment_id}": self._update_replicas},
        )
        #: The runtime the controller lives in (see _push_metrics_loop).
        self._runtime = get_runtime()
        self._stopped = threading.Event()
        self._metrics_thread = threading.Thread(
            target=self._push_metrics_loop, daemon=True,
            name=f"serve-router-metrics-{deployment_id}")
        self._metrics_thread.start()

    def _update_replicas(self, replicas: List[Dict[str, Any]]) -> None:
        self._scheduler.update_replicas(replicas or [])
        if replicas:
            self._max_queued_requests = int(
                replicas[0].get("max_queued_requests", -1))
            self._replicas_populated.set()
        else:
            self._replicas_populated.clear()
        # AFTER the scheduler swap: a membership change tears the compiled
        # graph down inside this callback (fallback within one tick), and
        # any request it re-dispatches must see the NEW replica set.
        self._compiled.on_replica_set(replicas or [])

    def _push_metrics_loop(self) -> None:
        """Handle-side queue metric reporting (ref: autoscaling_state.py —
        RUNNING replicas' queue lengths come from handles, pushed on the
        metrics interval)."""
        from ray_tpu_torch.exceptions import ActorDiedError

        while not self._stopped.wait(METRICS_PUSH_INTERVAL_S):
            if runtime_or_none() is not self._runtime:
                self._stopped.set()  # the runtime, and the controller, are gone
                self._compiled.stop()
                return
            self._compiled.maybe_compile()
            inflight = self._scheduler.total_inflight()
            INFLIGHT_GAUGE.set(inflight,
                               tags={"deployment": self.deployment_id})
            try:
                # The cumulative RED snapshot rides along, keyed by pid:
                # routers in one process share the process-global
                # histograms, so the controller keeps the LATEST snapshot
                # per (deployment, pid) and sums across pids.
                with self._wake_lock:
                    queued = self._wake_waiting
                self._controller.record_handle_metrics.remote(
                    self.deployment_id, self.router_id, inflight,
                    snapshot=serve_metrics.deployment_snapshot(
                        self.deployment_id),
                    pid=os.getpid(),
                    compiled=(self._compiled.mode == "compiled"),
                    queued=queued)
            except ActorDiedError:
                self._stopped.set()  # controller gone: stop reporting
                return
            except Exception:
                pass

    def _check_capacity(self) -> None:
        """Shed when the deployment is saturated (ref: the reference's
        handle-side max_queued_requests rejection).

        With max_queued_requests unset (-1), excess requests queue in the
        replicas' actor mailboxes.  With it set >= 0, at most that many
        requests may wait beyond the replicas' combined
        max_ongoing_requests capacity; the rest fail fast with
        BackPressureError so overload sheds instead of collapsing latency.
        """
        max_queued = self._max_queued_requests
        if max_queued < 0:
            return
        from ray_tpu_torch.serve.exceptions import BackPressureError

        inflight, capacity = self._scheduler.load()
        if capacity <= 0:
            # No replicas (startup, or scale-to-zero wake window): requests
            # queue in _dispatch rather than 503 — but boundedly.
            with self._wake_lock:
                waiting = self._wake_waiting
            if waiting >= max_queued:
                SHED_COUNTER.inc(tags={"deployment": self.deployment_id})
                raise BackPressureError(self.deployment_id, waiting, 0,
                                        max_queued)
            return
        if inflight >= capacity + max_queued:
            SHED_COUNTER.inc(tags={"deployment": self.deployment_id})
            raise BackPressureError(self.deployment_id, inflight, capacity,
                                    max_queued)

    def try_assign_compiled(self, method_name: str, *args, **kwargs):
        """Compiled fast path for unary requests.  Returns a
        CompiledResponse when the route is compiled and the request was
        lowered onto a channel, or None to use the dynamic path.  Capacity
        shedding fires exactly as on the dynamic path."""
        graph = self._compiled.graph
        if graph is None:
            return None
        self._check_capacity()
        return graph.submit(method_name, args, kwargs)

    def _dispatch(self, send, model_id: Optional[str] = None):
        """Shared choose-replica/retry core (ref: Router.assign_request):
        replicas dead at dispatch (a rolling update raced the long-poll)
        are dropped locally and the request re-assigned.
        ``send(replica)`` performs the (non-blocking) submit and returns
        its result.  ``model_id`` biases the pick toward warm multiplexed
        replicas."""
        from ray_tpu_torch.exceptions import ActorDiedError

        deadline = time.time() + 30.0
        while True:
            replica = self._scheduler.choose_replica(model_id)
            if replica is None:
                # Queue (don't fail) while the replica set is empty: for a
                # scaled-to-zero deployment this parked request IS the wake
                # signal.
                with self._wake_lock:
                    self._wake_waiting += 1
                try:
                    populated = self._replicas_populated.wait(
                        timeout=max(0.0, deadline - time.time()))
                finally:
                    with self._wake_lock:
                        self._wake_waiting -= 1
                if not populated:
                    raise TimeoutError(
                        f"No running replicas for {self.deployment_id} after 30s")
                continue
            rid = replica["replica_id"]
            # Count the request in flight BEFORE the submit: with the
            # increment after send() a fast reply could decrement first
            # (clamped at 0), leaving a permanent +1 in the estimate.
            self._scheduler.on_request_sent(rid)
            try:
                out = send(replica)
            except ActorDiedError:
                self._scheduler.on_request_done(rid)  # undo: never sent
                if not self._scheduler.drop_replica(rid):
                    self._replicas_populated.clear()
                if time.time() > deadline:
                    raise
                continue
            except BaseException:
                # Never sent, so the pre-send count must not leak.
                self._scheduler.on_request_done(rid)
                raise
            return replica, rid, out

    def assign_request(self, method_name: str, *args, **kwargs):
        """Pick a replica and dispatch; returns the ObjectRef."""
        self._check_capacity()
        t0 = time.time()
        # Route span: child of the caller's span (the proxy's root span or
        # an enclosing handle call), parent of the replica-side execute
        # span via the TaskSpec's trace context.
        attrs = self._span_attrs.get(method_name)
        if attrs is None:
            attrs = self._span_attrs[method_name] = {
                "deployment": self.deployment_id, "method": method_name}
        with _tracing.span("serve.route", attributes=attrs):
            trace_ctx = _tracing.active_span()
            _, rid, ref = self._dispatch(
                lambda r: r["actor"].handle_request.remote(
                    method_name, *args, **kwargs),
                model_id=kwargs.get("_serve_multiplexed_model_id"))
        # Decrement the local queue estimate when the reply lands — and if
        # the reply is the replica's death, drop it from the local set at
        # once so later requests can't re-pick the corpse.
        from ray_tpu_torch._private import runtime as _rt
        from ray_tpu_torch.exceptions import ActorDiedError

        tags = self._metric_tags
        exemplar = serve_metrics.trace_exemplar(trace_ctx)

        def _on_reply(f):
            self._scheduler.on_request_done(rid)
            serve_metrics.REQUEST_LATENCY.observe(
                time.time() - t0, tags=tags, exemplar=exemplar)
            serve_metrics.REQUESTS_TOTAL.inc(tags=tags)
            exc = f.exception()
            if exc is not None:
                serve_metrics.ERRORS_TOTAL.inc(tags=tags)
            if isinstance(exc, ActorDiedError):
                if not self._scheduler.drop_replica(rid):
                    self._replicas_populated.clear()

        fut = _rt.get_runtime().as_future(ref)
        fut.add_done_callback(_on_reply)
        return ref

    def assign_stream(self, method_name: str, *args, **kwargs):
        """Streaming dispatch: open a pull stream on one replica; returns
        (replica_actor, stream_id_REF, done_callback).  Non-blocking — the
        stream id resolves at the first pull, so calling from inside an
        async replica never stalls its event loop.  All pulls stay pinned
        to the opening replica."""
        self._check_capacity()
        t0 = time.time()
        attrs = self._stream_span_attrs.get(method_name)
        if attrs is None:
            attrs = self._stream_span_attrs[method_name] = {
                "deployment": self.deployment_id, "method": method_name,
                "stream": True}
        with _tracing.span("serve.route", attributes=attrs):
            trace_ctx = _tracing.active_span()
            replica, rid, sid_ref = self._dispatch(
                lambda r: r["actor"].start_stream.remote(
                    method_name, *args, **kwargs),
                model_id=kwargs.get("_serve_multiplexed_model_id"))
        tags = self._metric_tags
        exemplar = serve_metrics.trace_exemplar(trace_ctx)
        from ray_tpu_torch.exceptions import ActorDiedError

        def done(exc: Optional[BaseException] = None):
            # For streams, "latency" is assign -> stream end (last pull,
            # cancellation, or error) — the whole response window.
            self._scheduler.on_request_done(rid)
            if isinstance(exc, ActorDiedError) or isinstance(
                    getattr(exc, "cause", None), ActorDiedError):
                # The pinned replica died: drop it locally.
                if not self._scheduler.drop_replica(rid):
                    self._replicas_populated.clear()
            serve_metrics.REQUEST_LATENCY.observe(
                time.time() - t0, tags=tags, exemplar=exemplar)
            serve_metrics.REQUESTS_TOTAL.inc(tags=tags)

        return replica["actor"], sid_ref, done

    def stop(self) -> None:
        self._stopped.set()
        self._compiled.stop()
        self._long_poll.stop()
