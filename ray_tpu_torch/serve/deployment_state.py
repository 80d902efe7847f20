"""Deployment & replica state machines + self-healing reconciler (the
counterpart of ``ray_tpu/serve/deployment_state.py``).

(ref: python/ray/serve/_private/deployment_state.py — DeploymentState:1248
replica FSM with STARTING/RUNNING/DRAINING sets, rolling updates on version
change; DeploymentStateManager:2339 reconciles every control-loop tick;
health checks driven by health_check_period_s/health_check_timeout_s and
graceful drain by graceful_shutdown_* in the deployment config.)

Recovery is an always-on reconciliation loop, not an error path (Wang et
al., NSDI '21): every tick the reconciler probes RUNNING replicas, replaces
dead/unhealthy ones, and pushes the shrunken routing table immediately —
the router never has to discover a corpse per-request.
"""

from __future__ import annotations

import hashlib
import io
import pickle
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError
from ray_tpu_torch.serve import autoscaling as _autoscaling
from ray_tpu_torch.serve.config import DeploymentConfig
from ray_tpu_torch.serve.replica import ReplicaActor, SyncReplicaActor
from ray_tpu_torch.util import metrics as _metrics

#: Exponential crash-loop backoff for replica replacement after failed
#: starts: base * 2**(consecutive_failures - 1), capped (ref: the
#: reference's EXPONENTIAL_BACKOFF_FACTOR on repeated replica failures —
#: a bad __init__ must not hot-loop the cluster).
CRASH_LOOP_BACKOFF_BASE_S = 1.0
CRASH_LOOP_BACKOFF_MAX_S = 32.0

HEALTHY_GAUGE = _metrics.Gauge(
    "serve_num_healthy_replicas",
    "RUNNING replicas per deployment, as seen by the reconciler",
    tag_keys=("deployment",))
UNHEALTHY_GAUGE = _metrics.Gauge(
    "serve_num_unhealthy_replicas",
    "Replicas failing health checks (UNHEALTHY or draining after one)",
    tag_keys=("deployment",))
RESTARTS_COUNTER = _metrics.Counter(
    "serve_replica_restarts",
    "Replica replacements scheduled after a failed start, death, or "
    "failed health checks",
    tag_keys=("deployment",))


@dataclass
class DeploymentInfo:
    name: str
    app_name: str
    deployment_def: Any
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    config: DeploymentConfig = field(default_factory=DeploymentConfig)
    route_prefix: Optional[str] = None
    _version: Optional[str] = field(default=None, init=False, repr=False,
                                    compare=False)

    @property
    def id(self) -> str:
        return f"{self.app_name}#{self.name}"

    def version(self) -> str:
        """Code+config identity driving rolling updates (ref:
        deployment_state DeploymentVersion), computed once: every reconcile
        tick reads it. Init arguments are hashed by value, except tensors,
        which count by identity — a model's weights passed through
        ``.bind`` are not copied to the host to be hashed."""
        if self._version is None:
            h = hashlib.sha256()
            h.update(getattr(self.deployment_def, "__qualname__",
                             str(self.deployment_def)).encode())
            buf = io.BytesIO()
            try:
                _IdentityTensorPickler(buf).dump(
                    (self.init_args, self.init_kwargs, self.config.user_config))
                h.update(buf.getvalue())
            except Exception:
                h.update(repr((self.init_args, self.init_kwargs,
                               self.config.user_config)).encode())
            self._version = h.hexdigest()[:16]
        return self._version


class _IdentityTensorPickler(pickle.Pickler):
    """Pickles a torch tensor as its identity (``id``), not its bytes."""

    def persistent_id(self, obj: Any) -> Optional[str]:
        cls = type(obj)
        if cls.__module__.startswith("torch") and hasattr(obj, "data_ptr"):
            return f"tensor:{id(obj)}"
        return None


def _root_cause(e: BaseException) -> BaseException:
    """The innermost ``cause`` of a runtime error: an actor's death wraps
    the TaskError of its ``__init__``, which wraps what ``__init__``
    raised."""
    while getattr(e, "cause", None) is not None:
        e = e.cause
    return e


class ReplicaState:
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    #: Failed health checks / died; removed from routing, about to drain.
    UNHEALTHY = "UNHEALTHY"
    #: Removed from routing; in-flight requests+streams get
    #: graceful_shutdown_wait_loop_s to finish, hard kill at
    #: graceful_shutdown_timeout_s.
    DRAINING = "DRAINING"
    #: Pre-started (initialized, health-checked, weights pre-loaded) but
    #: held OUTSIDE the serving set; scale-up promotes WARM -> RUNNING
    #: instead of paying a cold start.
    WARM = "WARM"


class ReplicaWrapper:
    """One replica actor + its FSM state (ref: deployment_state.py
    DeploymentReplica)."""

    def __init__(self, info: DeploymentInfo, warm: bool = False):
        self.replica_id = f"{info.name}#{uuid.uuid4().hex[:6]}"
        self.version = info.version()
        self.state = ReplicaState.STARTING
        #: Warm-pool member: starts/health-checks like any replica but is
        #: excluded from live/routing until promoted by a scale-up.
        self.warm = warm
        self.started_at = time.time()
        self.stopping_since: Optional[float] = None
        #: Why this replica left RUNNING ("unhealthy", "dead") — feeds the
        #: unhealthy gauge while it drains.
        self.unhealthy_reason: Optional[str] = None
        #: Model ids loaded in this replica's multiplex LRU (pushed by the
        #: replica on load/eviction) — routers prefer warm replicas.
        self.multiplexed_model_ids: List[str] = []
        # Health-probe FSM (controller side).  The FIRST probe runs while
        # still STARTING: a replica enters RUNNING (and the routing table)
        # only after initialize + one successful check_health, which is
        # what gates old-version teardown during rolling updates.
        self._health_ref = None
        self._init_health_ref = None
        self._health_started = 0.0
        self._last_probe_time = 0.0
        self.consecutive_failures = 0
        self.passed_first_health = False
        self._config = info.config
        self._drain_wait_loop_s = info.config.graceful_shutdown_wait_loop_s
        self._drain_timeout_s = info.config.graceful_shutdown_timeout_s
        opts = dict(info.config.ray_actor_options)
        if opts.get("isolation") == "process" or opts.get("runtime_env"):
            # Process-tier replica: a sync actor class (an async actor
            # cannot cross the process boundary); GIL isolation for the
            # data plane (ref: every reference replica is its own worker
            # process).
            actor_cls = SyncReplicaActor
        else:
            actor_cls = ReplicaActor
        # Real per-replica concurrency on both tiers: thread replicas via
        # mailbox threads; process replicas via the seq-multiplexed worker
        # pipe and in-worker threads (_private/process_pool.py). +3
        # headroom keeps control-plane calls (check_health,
        # prepare_for_shutdown, cancel_stream) from starving behind a
        # data-saturated semaphore.
        opts.setdefault("max_concurrency",
                        max(1, info.config.max_ongoing_requests) + 3)
        self.actor = ray_tpu_torch.remote(actor_cls).options(**opts).remote(
            info.name, self.replica_id, info.deployment_def,
            info.init_args, dict(info.init_kwargs),
            user_config=info.config.user_config,
            max_ongoing_requests=info.config.max_ongoing_requests)
        self._ready_ref = self.actor.initialize_and_get_metadata.remote()
        self._stop_ref = None
        #: Why the start failed (construction or first health check).
        self.start_error: Optional[BaseException] = None

    def check_ready(self) -> Optional[bool]:
        """True ready / False failed / None still starting.

        Two phases: initialize_and_get_metadata, then the replica's first
        check_health() — it is not routable until both succeed, so a
        deployment reported HEALTHY has probed healthy at least once."""
        if self._init_health_ref is None:
            ready, _ = ray_tpu_torch.wait([self._ready_ref], num_returns=1,
                                    timeout=0)
            if not ready:
                return None
            try:
                ray_tpu_torch.get(self._ready_ref)
            except Exception as e:
                self.start_error = _root_cause(e)
                return False
            self._init_health_ref = self.actor.check_health.remote()
            self._health_started = time.time()
            return None
        done, _ = ray_tpu_torch.wait([self._init_health_ref], num_returns=1,
                               timeout=0)
        if done:
            try:
                ray_tpu_torch.get(self._init_health_ref)
            except Exception as e:
                self.start_error = _root_cause(e)
                return False
            self.passed_first_health = True
            self._last_probe_time = time.time()
            return True
        if time.time() - self._health_started > self._config.health_check_timeout_s:
            return False  # initial probe wedged: a failed start
        return None

    # ------------------------------------------------------------- health
    def probe_health(self, now: float, config: DeploymentConfig) -> Optional[str]:
        """Drive the periodic check_health() probe for a RUNNING replica.

        Returns "dead" the moment the actor is observed dead, "unhealthy"
        once consecutive failures (probe raised, or outstanding past
        health_check_timeout_s) reach the threshold, else None.
        """
        if self._health_ref is None:
            if now - self._last_probe_time >= config.health_check_period_s:
                self._health_ref = self.actor.check_health.remote()
                self._health_started = now
            return None
        done, _ = ray_tpu_torch.wait([self._health_ref], num_returns=1, timeout=0)
        if done:
            ref, self._health_ref = self._health_ref, None
            self._last_probe_time = now
            try:
                ray_tpu_torch.get(ref)
            except ActorDiedError:
                return "dead"
            except Exception:
                self.consecutive_failures += 1
            else:
                self.consecutive_failures = 0
                self.passed_first_health = True
                return None
        elif now - self._health_started > config.health_check_timeout_s:
            # Probe wedged: count it and let the next period re-probe.
            self._health_ref = None
            self._last_probe_time = now
            self.consecutive_failures += 1
        if self.consecutive_failures >= config.health_check_failure_threshold:
            return "unhealthy"
        return None

    # -------------------------------------------------------------- drain
    def begin_drain(self, reason: Optional[str] = None) -> None:
        """DRAINING: out of routing, in-flight work gets
        graceful_shutdown_wait_loop_s, hard kill at
        graceful_shutdown_timeout_s (both from the deployment config)."""
        self.state = ReplicaState.DRAINING
        self.stopping_since = time.time()
        if reason is not None:
            self.unhealthy_reason = reason
        self._stop_ref = self.actor.prepare_for_shutdown.remote(
            self._drain_wait_loop_s)


    def hard_kill(self) -> None:
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass

    def check_stopped(self) -> bool:
        if self._stop_ref is None:
            return True
        done, _ = ray_tpu_torch.wait([self._stop_ref], num_returns=1, timeout=0)
        # Hard-kill deadline counts from when draining BEGAN, not creation —
        # else any replica older than the deadline loses its graceful drain.
        if done or time.time() - self.stopping_since > self._drain_timeout_s:
            self.hard_kill()
            return True
        return False


class DeploymentState:
    """Reconciles actual replicas toward the target (ref:
    deployment_state.py DeploymentState.update())."""

    def __init__(self, info: DeploymentInfo):
        self.info = info
        autoscaling = info.config.autoscaling_config
        if autoscaling is not None:
            # initial_replicas wins when set (0 is a valid choice: start
            # asleep, wake on first queued request).  Otherwise seed at
            # max(min_replicas, 1) so min_replicas=0 does NOT mean "deploy
            # zero replicas and wait" — the deployment starts serving and
            # idles down to zero later.
            if autoscaling.initial_replicas is not None:
                self.target_num = autoscaling.initial_replicas
            else:
                self.target_num = max(autoscaling.min_replicas, 1)
        else:
            self.target_num = info.config.num_replicas
        self.replicas: List[ReplicaWrapper] = []
        self.deleting = False
        self._changed = True
        # Crash-loop backoff (consecutive failed starts gate replacements).
        self.consecutive_start_failures = 0
        self.backoff_until = 0.0
        self.num_restarts = 0  # mirror of the counter, for status()
        self.num_cold_starts = 0
        self.num_warm_promotions = 0
        #: The last failed start's cause (serve.run raises it).
        self.last_start_error: Optional[BaseException] = None
        #: Why the running set last changed (deploy / replica_death /
        #: drain / rolling_update / autoscale) — stamped onto the rows
        #: routers receive.
        self.change_reason = "deploy"
        #: Where the current target_num came from: "config" (deploy /
        #: set_target) or "autoscale" (set_target_num) — decides whether a
        #: scale-down drain reads as autoscale or plain drain.
        self._target_source = "config"

    # ------------------------------------------------------------- targets
    def set_target(self, info: DeploymentInfo) -> None:
        old_version = self.info.version()
        autoscaling = info.config.autoscaling_config
        if autoscaling:
            self.target_num = min(max(self.target_num,
                                      autoscaling.min_replicas),
                                  autoscaling.max_replicas)
        else:
            self.target_num = info.config.num_replicas
        self.info = info
        self._target_source = "config"
        if info.version() != old_version:
            self._changed = True
            # New code/config gets a fresh chance immediately: the backoff
            # guarded the OLD version's crash loop.
            self.consecutive_start_failures = 0
            self.backoff_until = 0.0

    def set_target_num(self, n: int) -> None:
        """Autoscaler entry point."""
        if n != self.target_num:
            self.target_num = n
            self._changed = True
            self._target_source = "autoscale"
            self.change_reason = "autoscale"

    def delete(self) -> None:
        self.deleting = True
        self.target_num = 0

    # ----------------------------------------------------------- internals
    def _record_failure(self, now: float) -> None:
        """One replica start failed: grow the crash-loop backoff window."""
        self.consecutive_start_failures += 1
        backoff = min(
            CRASH_LOOP_BACKOFF_BASE_S * 2 ** (self.consecutive_start_failures - 1),
            CRASH_LOOP_BACKOFF_MAX_S)
        self.backoff_until = max(self.backoff_until, now + backoff)

    def _record_restart(self) -> None:
        self.num_restarts += 1
        RESTARTS_COUNTER.inc(tags={"deployment": self.info.id})

    def _start_replica(self) -> None:
        self.replicas.append(ReplicaWrapper(self.info))

    def _can_start(self, now: float) -> bool:
        return now >= self.backoff_until

    # ------------------------------------------------------------ reconcile
    def reconcile(self) -> bool:
        """One tick; returns True if the running-replica set changed."""
        changed = False
        now = time.time()
        config = self.info.config
        target_version = self.info.version()

        # STARTING → RUNNING / failed (failed starts feed the crash-loop
        # backoff so a bad __init__ can't hot-loop replacements).  Warm-pool
        # members ready up separately (STARTING → WARM, below).
        for r in list(self.replicas):
            if r.state == ReplicaState.STARTING and not r.warm:
                ready = r.check_ready()
                if ready is True:
                    r.state = ReplicaState.RUNNING
                    self.consecutive_start_failures = 0
                    self.backoff_until = 0.0
                    changed = True
                elif ready is False:
                    self.replicas.remove(r)
                    r.hard_kill()
                    self.last_start_error = r.start_error
                    self._record_failure(now)
                    self._record_restart()

        # RUNNING → UNHEALTHY on failed probes / observed death.  The
        # transition leaves running_replicas() immediately, so the changed
        # flag pushes the shrunken routing table this same tick.
        for r in self.replicas:
            if r.state != ReplicaState.RUNNING:
                continue
            verdict = r.probe_health(now, config)
            if verdict is not None:
                r.state = ReplicaState.UNHEALTHY
                r.unhealthy_reason = verdict
                self.change_reason = "replica_death"
                if not r.passed_first_health:
                    # Crashed before ever probing healthy: treat like a
                    # failed start so an init-OK-then-instant-crash loop
                    # still backs off.
                    self._record_failure(now)
                self._record_restart()
                changed = True

        # UNHEALTHY → DRAINING (dead actors skip the drain — nothing to
        # wait for) — the replacement starts below via the scale-up path.
        for r in list(self.replicas):
            if r.state == ReplicaState.UNHEALTHY:
                if r.unhealthy_reason == "dead":
                    r.hard_kill()
                    self.replicas.remove(r)
                else:
                    r.begin_drain()

        # DRAINING → gone
        for r in list(self.replicas):
            if r.state == ReplicaState.DRAINING and r.check_stopped():
                self.replicas.remove(r)

        self._reconcile_warm_pool(now, config, target_version)

        live = [r for r in self.replicas if not r.warm
                and r.state in (ReplicaState.STARTING, ReplicaState.RUNNING)]

        # Rolling update: drain outdated replicas once a same-or-newer
        # replacement is RUNNING and has passed its FIRST health check, and
        # never let the healthy count drop below target - max_unavailable
        # (ref: deployment_state rolling update with max surge).
        outdated = [r for r in live if r.version != target_version]
        if outdated and not self.deleting:
            current = [r for r in live if r.version == target_version]
            if len(current) < self.target_num and \
                    len(live) <= self.target_num and self._can_start(now):
                self._start_replica()  # surge of one while updating
            healthy_current = [r for r in current
                               if r.state == ReplicaState.RUNNING
                               and r.passed_first_health]
            num_healthy = sum(1 for r in live
                              if r.state == ReplicaState.RUNNING
                              and r.passed_first_health)
            floor = max(0, self.target_num - max(0, config.max_unavailable))
            if healthy_current or self.target_num == 0:
                # Prefer a victim that is not serving (STARTING) — it costs
                # no capacity; else drain one RUNNING outdated replica only
                # if the floor survives it.
                victims = sorted(outdated,
                                 key=lambda r: r.state == ReplicaState.RUNNING)
                for victim in victims:
                    serving = (victim.state == ReplicaState.RUNNING
                               and victim.passed_first_health)
                    if serving and num_healthy - 1 < floor \
                            and self.target_num > 0:
                        continue  # would violate the availability floor
                    victim.begin_drain()
                    changed = True
                    self.change_reason = "rolling_update"
                    break  # one per tick, as before
            return True  # keep reconciling until the update converges

        # Scale up/down to target (auto-recovery lands here: a removed
        # dead/unhealthy replica leaves live < target), gated by the
        # crash-loop backoff.  Scale-up drains the warm pool first — a
        # promotion is a state flip, not an actor start, so a wake from
        # zero costs one reconcile tick instead of a checkpoint load.
        if len(live) < self.target_num:
            deficit = self.target_num - len(live)
            for r in self.replicas:
                if deficit <= 0:
                    break
                if r.warm and r.state in (ReplicaState.WARM,
                                          ReplicaState.STARTING):
                    r.warm = False
                    if r.state == ReplicaState.WARM:
                        r.state = ReplicaState.RUNNING
                        changed = True
                    self.num_warm_promotions += 1
                    _autoscaling.WARM_PROMOTIONS.inc(
                        tags={"deployment": self.info.id})
                    deficit -= 1
            if deficit > 0 and self._can_start(now):
                for _ in range(deficit):
                    self._start_replica()
                    if self.info.config.autoscaling_config is not None:
                        self.num_cold_starts += 1
                        _autoscaling.COLD_STARTS.inc(
                            tags={"deployment": self.info.id})
        elif len(live) > self.target_num:
            # Prefer draining replicas that are still starting (they cost
            # no capacity).
            victims = sorted(live, key=lambda r: r.state == ReplicaState.RUNNING)
            for r in victims[: len(live) - self.target_num]:
                r.begin_drain()
                changed = True
            self.change_reason = ("autoscale"
                                  if self._target_source == "autoscale"
                                  else "drain")
        return changed

    def _reconcile_warm_pool(self, now: float, config: DeploymentConfig,
                             target_version: str) -> None:
        """Keep ``warm_pool_size`` replicas pre-started outside the serving
        set: ready them up (STARTING → WARM, then fire the multiplex
        prewarm), health-probe them so corpses leave the pool, drain
        outdated or excess members, and start replacements."""
        autoscaling = config.autoscaling_config
        warm_target = autoscaling.warm_pool_size if autoscaling else 0
        if self.deleting:
            warm_target = 0
        for r in list(self.replicas):
            if not r.warm:
                continue
            if r.state == ReplicaState.STARTING:
                ready = r.check_ready()
                if ready is True:
                    r.state = ReplicaState.WARM
                    if autoscaling and autoscaling.prewarm_model_ids:
                        try:
                            r.actor.prewarm.remote(
                                list(autoscaling.prewarm_model_ids))
                        except Exception:
                            pass
                elif ready is False:
                    self.replicas.remove(r)
                    r.hard_kill()
                    self.last_start_error = r.start_error
                    self._record_failure(now)
            elif r.state == ReplicaState.WARM:
                if r.version != target_version:
                    r.warm = False
                    r.begin_drain()
                elif r.probe_health(now, config) is not None:
                    # A warm corpse never served traffic: replace quietly.
                    r.hard_kill()
                    self.replicas.remove(r)
        warm = [r for r in self.replicas if r.warm]
        if len(warm) > warm_target:
            for r in warm[warm_target:]:
                r.warm = False
                r.begin_drain()
        elif len(warm) < warm_target and self._can_start(now):
            for _ in range(warm_target - len(warm)):
                self.replicas.append(ReplicaWrapper(self.info, warm=True))

    # -------------------------------------------------------------- queries
    def running_replicas(self) -> List[Dict[str, Any]]:
        return [{"replica_id": r.replica_id, "actor": r.actor,
                 "max_ongoing_requests": self.info.config.max_ongoing_requests,
                 "max_queued_requests": self.info.config.max_queued_requests,
                 "change_reason": self.change_reason,
                 "multiplexed_model_ids": list(r.multiplexed_model_ids)}
                for r in self.replicas if r.state == ReplicaState.RUNNING]

    @property
    def is_deleted(self) -> bool:
        return self.deleting and not self.replicas

    def num_running(self) -> int:
        return sum(1 for r in self.replicas if r.state == ReplicaState.RUNNING)

    def num_warm(self) -> int:
        return sum(1 for r in self.replicas if r.warm)

    def num_unhealthy(self) -> int:
        return sum(1 for r in self.replicas if r.unhealthy_reason is not None)

    def replica_rows(self) -> List[Dict[str, Any]]:
        """Observability rows for list_replicas() / /api/serve — FSM state
        per replica, joined with controller-side health bookkeeping."""
        now = time.time()
        return [{
            "replica_id": r.replica_id,
            "deployment": self.info.name,
            "app": self.info.app_name,
            "deployment_id": self.info.id,
            "state": r.state,
            "warm": r.warm,
            "version": r.version,
            "uptime_s": round(now - r.started_at, 3),
            "unhealthy_reason": r.unhealthy_reason,
            "consecutive_health_failures": r.consecutive_failures,
        } for r in self.replicas]


class DeploymentStateManager:
    """(ref: deployment_state.py:2339 DeploymentStateManager)"""

    def __init__(self) -> None:
        self.deployments: Dict[str, DeploymentState] = {}

    def deploy(self, info: DeploymentInfo) -> None:
        state = self.deployments.get(info.id)
        if state is None:
            state = self.deployments[info.id] = DeploymentState(info)
        else:
            state.deleting = False
            state.set_target(info)

    def delete(self, deployment_id: str) -> None:
        if deployment_id in self.deployments:
            self.deployments[deployment_id].delete()

    def record_multiplexed_model_ids(self, replica_id: str,
                                     model_ids: List[str]) -> bool:
        """Stamp a replica's loaded multiplex ids and flag its deployment
        changed (the next reconcile tick pushes the new replica set to
        routers).  Replica ids are unique across deployments, so a scan
        suffices.  Returns False for unknown/departed replicas."""
        for state in self.deployments.values():
            for r in state.replicas:
                if r.replica_id == replica_id:
                    if r.multiplexed_model_ids != list(model_ids):
                        r.multiplexed_model_ids = list(model_ids)
                        state._changed = True
                    return True
        return False

    def reconcile(self) -> Dict[str, List[Dict[str, Any]]]:
        """Tick all deployments; return {deployment_id: running_replicas}
        for those whose replica membership changed."""
        updates: Dict[str, List[Dict[str, Any]]] = {}
        for dep_id, state in list(self.deployments.items()):
            if state.reconcile() or state._changed:
                updates[dep_id] = state.running_replicas()
                state._changed = False
            if state.is_deleted:
                del self.deployments[dep_id]
                updates[dep_id] = []
        # Rebuild the health gauges from scratch each tick so a deleted
        # deployment's series doesn't report its stale last value forever.
        HEALTHY_GAUGE.clear()
        UNHEALTHY_GAUGE.clear()
        _autoscaling.WARM_POOL_SIZE.clear()
        for dep_id, state in self.deployments.items():
            HEALTHY_GAUGE.set(state.num_running(),
                              tags={"deployment": dep_id})
            UNHEALTHY_GAUGE.set(state.num_unhealthy(),
                                tags={"deployment": dep_id})
            if state.info.config.autoscaling_config is not None:
                _autoscaling.WARM_POOL_SIZE.set(
                    state.num_warm(), tags={"deployment": dep_id})
        return updates
