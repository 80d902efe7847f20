"""ServeController — the Serve control plane actor (the counterpart of
``ray_tpu/serve/controller.py``).

(ref: python/ray/serve/_private/controller.py:84 ServeController — async
actor reconciling application/deployment state every tick, broadcasting
replica membership via LongPollHost, running autoscaling off replica queue
metrics (autoscaling_state.py); the request path never touches it.)
"""

from __future__ import annotations

import asyncio
import io
import logging
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.serve import autoscaling as _autoscaling
from ray_tpu_torch.serve.config import DeploymentConfig
from ray_tpu_torch.serve.deployment_state import DeploymentInfo, DeploymentStateManager
from ray_tpu_torch.serve.long_poll import LongPollHost

CONTROL_LOOP_INTERVAL_S = 0.05


class _RecordPickler(pickle.Pickler):
    """Pickles an app record and notes whether it holds an ObjectRef."""

    holds_refs = False

    def persistent_id(self, obj: Any) -> None:
        if isinstance(obj, ObjectRef):
            self.holds_refs = True
        return None


class ServeController:
    def __init__(self) -> None:
        self._manager = DeploymentStateManager()
        self._long_poll = LongPollHost()
        self._apps: Dict[str, Dict[str, Any]] = {}  # app -> {route_prefix, deployments, ingress}
        #: dep_id -> DeploymentAutoscaler (policy + hysteresis state).
        self._autoscalers: Dict[str, _autoscaling.DeploymentAutoscaler] = {}
        #: dep_id -> router_id -> (total_inflight, ts); handle-reported
        #: (ref: autoscaling_state.py — queue metrics come from handles)
        self._handle_metrics: Dict[str, Dict[str, tuple]] = {}
        #: dep_id -> router_id -> (queued_with_no_replica, ts) — requests
        #: parked in router dispatch loops because the replica set is empty;
        #: the zero->one wake signal for scale-to-zero deployments.
        self._queued_metrics: Dict[str, Dict[str, tuple]] = {}
        #: dep_id -> pid -> (RED snapshot, ts).  Snapshots are CUMULATIVE
        #: per process (routers in one process share the process-global
        #: histograms), so rollups keep the latest per pid and sum across
        #: pids — never across routers.
        self._metric_snaps: Dict[str, Dict[int, tuple]] = {}
        self._loop_task: Optional[asyncio.Task] = None
        self._shutdown = False

    async def _ensure_loop(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(
                self.run_control_loop())
            self._restore_persisted_apps()

    # ------------------------------------------------------ app persistence
    # Deployed applications survive a restart of the process when the
    # internal KV is WAL-backed (RAY_TPU_KV_PERSIST=1): each deploy/delete
    # writes the app record to the "serve-apps" namespace; a fresh
    # controller redeploys them (ref: the reference's GCS-checkpointed serve
    # controller state — serve/_private/application_state.py). Without the
    # WAL the record would outlive nothing, so none is written: a model's
    # weights bound as init arguments are not copied into the KV.
    _KV_NS = "serve-apps"
    #: Record-format magic: records of another format are skipped, not
    #: interpreted.
    _KV_MAGIC = b"RTPT-SRV1\x00"

    def _persist_app(self, app_name: str, record: dict) -> None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.experimental import internal_kv as kv

        if not GLOBAL_CONFIG.kv_persist:
            return
        buf = io.BytesIO()
        pickler = _RecordPickler(buf)
        try:
            pickler.dump(record)
        except Exception:  # noqa: BLE001 — persistence is best-effort
            logging.getLogger("ray_tpu_torch.serve").exception(
                "app %r cannot be pickled; it will NOT be restored after a "
                "restart", app_name)
            self._unpersist_app(app_name)
            return
        if pickler.holds_refs:
            # ObjectRefs in init args name THIS process's objects; a
            # restarted process could never resolve them — skip, loudly,
            # and drop any older persisted version so a stale app cannot
            # come back in its place after a restart.
            logging.getLogger("ray_tpu_torch.serve").warning(
                "app %r binds ObjectRef init args; it will NOT be "
                "restored after a restart (pass plain values or "
                "re-deploy after restarts)", app_name)
            self._unpersist_app(app_name)
            return
        kv._internal_kv_put(app_name, self._KV_MAGIC + buf.getvalue(),
                            namespace=self._KV_NS)

    def _unpersist_app(self, app_name: str) -> None:
        from ray_tpu_torch.experimental import internal_kv as kv

        kv._internal_kv_del(app_name, namespace=self._KV_NS)

    def _restore_persisted_apps(self) -> None:
        from ray_tpu_torch.experimental import internal_kv as kv

        names = kv._internal_kv_list("", namespace=self._KV_NS)
        for name in names:
            try:
                raw = kv._internal_kv_get(name, namespace=self._KV_NS)
                if not raw or not raw.startswith(self._KV_MAGIC):
                    logging.getLogger("ray_tpu_torch.serve").warning(
                        "skipping persisted serve app %r: unknown record "
                        "format", name)
                    continue
                # The WAL is this program's own file (session_dir).
                record = pickle.loads(raw[len(self._KV_MAGIC):])
                # Build EVERY DeploymentInfo before deploying ANY: a bad
                # second deployment must not leave the first one running
                # as an orphan with no _apps entry to delete it through.
                infos = [
                    DeploymentInfo(
                        name=d["name"], app_name=record["app_name"],
                        deployment_def=d["deployment_def"],
                        init_args=tuple(d.get("init_args", ())),
                        init_kwargs=dict(d.get("init_kwargs", {})),
                        config=d.get("config") or DeploymentConfig(),
                        route_prefix=record["route_prefix"])
                    for d in record["deployments"]
                ]
                for info in infos:
                    self._manager.deploy(info)
                self._apps[record["app_name"]] = {
                    "route_prefix": record["route_prefix"],
                    "deployments": sorted(d["name"]
                                          for d in record["deployments"]),
                    "ingress": record["ingress"],
                    "streaming": record.get("streaming", False),
                }
            except Exception:  # noqa: BLE001 — a bad record must not wedge
                logging.getLogger("ray_tpu_torch.serve").exception(
                    "failed to restore persisted serve app %r", name)
        if names:
            self._broadcast_routes()

    # ------------------------------------------------------------ app deploy
    async def deploy_application(self, app_name: str, route_prefix: Optional[str],
                                 ingress_name: str,
                                 deployments: List[Dict[str, Any]],
                                 ingress_streaming: bool = False) -> None:
        """(ref: controller.py deploy_application / application_state.py)"""
        await self._ensure_loop()
        new_names = {d["name"] for d in deployments}
        old = self._apps.get(app_name)
        if old:
            for name in old["deployments"]:
                if name not in new_names:
                    self._manager.delete(f"{app_name}#{name}")
        for d in deployments:
            info = DeploymentInfo(
                name=d["name"], app_name=app_name,
                deployment_def=d["deployment_def"],
                init_args=tuple(d.get("init_args", ())),
                init_kwargs=dict(d.get("init_kwargs", {})),
                config=d.get("config") or DeploymentConfig(),
                route_prefix=route_prefix)
            self._manager.deploy(info)
        self._apps[app_name] = {
            "route_prefix": route_prefix,
            "deployments": sorted(new_names),
            "ingress": ingress_name,
            "streaming": bool(ingress_streaming),
        }
        self._persist_app(app_name, {
            "app_name": app_name, "route_prefix": route_prefix,
            "ingress": ingress_name, "streaming": bool(ingress_streaming),
            "deployments": deployments,
        })
        self._broadcast_routes()

    async def delete_application(self, app_name: str) -> None:
        # Restore first: deleting right after a head restart must remove
        # the PERSISTED app too, not miss it and let it resurrect later.
        await self._ensure_loop()
        app = self._apps.pop(app_name, None)
        if not app:
            return
        self._unpersist_app(app_name)
        for name in app["deployments"]:
            self._manager.delete(f"{app_name}#{name}")
        self._broadcast_routes()

    def _broadcast_routes(self) -> None:
        routes = {}
        for name, app in self._apps.items():
            entry = {"app_name": name, "ingress": app["ingress"],
                     "streaming": app.get("streaming", False)}
            if app["route_prefix"]:
                routes[app["route_prefix"]] = entry
        self._long_poll.notify_changed({"route_table": routes})

    # ---------------------------------------------------------- control loop
    async def run_control_loop(self) -> None:
        while not self._shutdown:
            try:
                updates = self._manager.reconcile()
                if updates:
                    self._long_poll.notify_changed({
                        f"replicas::{dep_id}": replicas
                        for dep_id, replicas in updates.items()
                    })
                await self._autoscale_tick()
            except Exception:
                import traceback

                traceback.print_exc()
            await asyncio.sleep(CONTROL_LOOP_INTERVAL_S)

    def record_multiplexed_model_ids(self, replica_id: str,
                                     model_ids: List[str]) -> None:
        """A replica's multiplex LRU changed (load or eviction).  Stamp
        the ids onto the controller-side replica record and mark the
        deployment changed so the next control-loop tick pushes a fresh
        replica set — routers then prefer warm replicas for those ids."""
        self._manager.record_multiplexed_model_ids(replica_id, model_ids)

    def record_handle_metrics(self, deployment_id: str, router_id: str,
                              total_inflight: int,
                              snapshot: Optional[Dict[str, Any]] = None,
                              pid: Optional[int] = None,
                              queued: Optional[int] = None) -> None:
        """Handle-side queue report (ref: autoscaling_state.py
        record_request_metrics_for_handle).  Routers additionally attach a
        cumulative per-process RED snapshot for the status rollups and how
        many requests are parked waiting for a non-empty replica set (the
        wake-from-zero signal)."""
        now = time.time()
        self._handle_metrics.setdefault(deployment_id, {})[router_id] = (
            int(total_inflight), now)
        if queued is not None:
            self._queued_metrics.setdefault(deployment_id, {})[router_id] = (
                int(queued), now)
        if snapshot is not None and pid is not None:
            self._metric_snaps.setdefault(deployment_id, {})[int(pid)] = (
                snapshot, now)

    def _latency_rollup(self, deployment_id: str) -> Dict[str, Any]:
        from ray_tpu_torch.serve import metrics as serve_metrics

        snaps = [snap for snap, _ in
                 self._metric_snaps.get(deployment_id, {}).values()]
        return serve_metrics.rollup(snaps)

    async def _autoscale_tick(self) -> None:
        """SLO-driven autoscaling: feed each deployment's policy layer
        (serve/autoscaling.py — queue depth, target-qps, and burn-rate
        policies composed by max, with hysteresis/cooldowns/crash-loop
        interlock) one sensing snapshot and apply the decision.

        The ``serve_autoscale`` fault point is consulted BEFORE
        set_target_num: an injected scale-decision failure leaves the
        target — and therefore the replica FSM — untouched."""
        from ray_tpu_torch.serve import metrics as serve_metrics
        from ray_tpu_torch.serve import slo as serve_slo

        now = time.time()
        slo_payload = None
        watchdog = serve_slo.get_watchdog()
        for dep_id, state in list(self._manager.deployments.items()):
            cfg = state.info.config.autoscaling_config
            if cfg is None or state.deleting:
                self._autoscalers.pop(dep_id, None)
                continue
            scaler = self._autoscalers.get(dep_id)
            if scaler is None or scaler.config is not cfg:
                scaler = self._autoscalers[dep_id] = \
                    _autoscaling.DeploymentAutoscaler(dep_id, cfg)
            if now - scaler.last_check < cfg.metrics_interval_s:
                continue
            scaler.last_check = now
            fresh = [n for n, ts in
                     self._handle_metrics.get(dep_id, {}).values()
                     if now - ts < 2.0]
            queued = sum(q for q, ts in
                         self._queued_metrics.get(dep_id, {}).values()
                         if now - ts < 2.0)
            burn_alerting, burn_quiet = False, True
            if cfg.use_slo_burn and watchdog.has_objectives():
                if slo_payload is None:  # one evaluate() per tick, shared
                    slo_payload = watchdog.evaluate(now=now)
                burn_alerting, burn_quiet = self._burn_state(
                    slo_payload, dep_id)
            rate = 0.0
            if cfg.target_qps_per_replica:
                rate = serve_metrics.request_rate(
                    dep_id, window_s=cfg.qps_window_s, now=now)
            inputs = _autoscaling.PolicyInputs(
                now=now,
                num_running=state.num_running(),
                target_num=state.target_num,
                total_inflight=sum(fresh),
                queued_requests=queued,
                request_rate=rate,
                batch_occupancy=serve_metrics.batch_occupancy(
                    window_s=cfg.qps_window_s, now=now)
                if cfg.target_qps_per_replica else 0.0,
                burn_alerting=burn_alerting,
                burn_quiet=burn_quiet,
                in_backoff=now < state.backoff_until)
            decision = scaler.decide(inputs)
            if not decision.changed or decision.target == state.target_num:
                continue
            try:
                fault_injection.check("serve_autoscale")
            except fault_injection.InjectedFailure:
                _autoscaling.record_rejected(dep_id)
                continue
            old = state.target_num
            state.set_target_num(decision.target)
            _autoscaling.record_applied(dep_id, old, decision.target,
                                        decision.reason)

    @staticmethod
    def _burn_state(slo_payload: Dict[str, Any],
                    dep_id: str) -> Tuple[bool, bool]:
        """(alerting, all-windows-quiet) for one deployment from a shared
        watchdog evaluation (objectives may key the full "app#name" id or
        the bare deployment name)."""
        for key in (dep_id, dep_id.partition("#")[2]):
            dep_slo = slo_payload.get(key)
            if not dep_slo:
                continue
            quiet = all(
                o.get("burn_fast", 0.0) < o.get("burn_threshold", 1.0)
                and o.get("burn_slow", 0.0) < o.get("burn_threshold", 1.0)
                for o in dep_slo.get("objectives", {}).values())
            return bool(dep_slo.get("alerting")), quiet
        return False, True

    # --------------------------------------------------------------- queries
    async def listen_for_change(self, keys_to_snapshot_ids: Dict[str, int],
                                timeout_s: float = 30.0):
        await self._ensure_loop()
        return await self._long_poll.listen_for_change(keys_to_snapshot_ids,
                                                       timeout_s)

    async def get_app_config(self, app_name: str) -> Optional[Dict[str, Any]]:
        await self._ensure_loop()  # restore persisted apps before answering
        return self._apps.get(app_name)

    async def list_applications(self) -> List[str]:
        await self._ensure_loop()
        return sorted(self._apps)

    async def get_deployment_status(self) -> Dict[str, Dict[str, Any]]:
        """(ref: serve.status() — DeploymentStatus per deployment).  Async
        so it can kick the control loop (and the persisted-app restore) for
        callers that query before any deploy/long-poll touched it."""
        await self._ensure_loop()
        out = {}
        now = time.time()
        for dep_id, state in self._manager.deployments.items():
            running = state.num_running()
            unhealthy = state.num_unhealthy()
            if running >= state.target_num:
                status = "HEALTHY"
            elif unhealthy or state.consecutive_start_failures:
                # Short of target because replicas are failing (probes or
                # starts) — distinct from a rolling update in progress.
                status = "UNHEALTHY"
            else:
                status = "UPDATING"
            out[dep_id] = {
                "target_num_replicas": state.target_num,
                "running_replicas": running,
                "unhealthy_replicas": unhealthy,
                "replica_restarts": state.num_restarts,
                "consecutive_start_failures": state.consecutive_start_failures,
                "backoff_remaining_s": round(
                    max(0.0, state.backoff_until - now), 3),
                "status": status,
                # The last failed start's cause, for serve.run to raise.
                "last_start_error": (repr(state.last_start_error)
                                     if state.last_start_error else None),
                # RED rollup from router-pushed snapshots (p50/p95/p99
                # latency + request/error totals) — serve.status() answers
                # "where did the latency go" without scraping /metrics.
                **self._latency_rollup(dep_id),
            }
            cfg = state.info.config.autoscaling_config
            if cfg is not None:
                scaler = self._autoscalers.get(dep_id)
                out[dep_id]["autoscale"] = {
                    "min_replicas": cfg.min_replicas,
                    "max_replicas": cfg.max_replicas,
                    "warm_pool_size": cfg.warm_pool_size,
                    "warm_replicas": state.num_warm(),
                    "cold_starts": state.num_cold_starts,
                    "warm_promotions": state.num_warm_promotions,
                    "queued_requests": sum(
                        q for q, ts in
                        self._queued_metrics.get(dep_id, {}).values()
                        if now - ts < 2.0),
                    "last_decision_reason": (scaler.last_reason
                                             if scaler else None),
                    "last_change_at": (scaler.last_change_at
                                       if scaler else None),
                }
        return out

    async def set_target_num(self, deployment_id: str, n: int) -> bool:
        """Operator/test override of one deployment's replica target (the
        same actuator the autoscaler uses; the policy layer may move it
        again on its next evaluation)."""
        await self._ensure_loop()
        state = self._manager.deployments.get(deployment_id)
        if state is None:
            return False
        old = state.target_num
        state.set_target_num(n)
        if n != old:
            _autoscaling.record_applied(deployment_id, old, n, "manual")
        return True

    async def list_deployments(self) -> List[Dict[str, Any]]:
        """Deployment rows joining controller state with live RED rollups
        (ref: the reference's serve state API / dashboard deployments
        view)."""
        status = await self.get_deployment_status()
        rows = []
        for dep_id, st in sorted(status.items()):
            state = self._manager.deployments.get(dep_id)
            app, _, name = dep_id.partition("#")
            inflight = sum(
                n for n, ts in
                self._handle_metrics.get(dep_id, {}).values()
                if time.time() - ts < 2.0)
            rows.append({
                "deployment_id": dep_id, "app": app, "name": name,
                "route_prefix": (state.info.route_prefix
                                 if state is not None else None),
                "num_replicas": (len(state.replicas)
                                 if state is not None else 0),
                "inflight_requests": inflight,
                **st,
            })
        return rows

    async def list_replicas(self) -> List[Dict[str, Any]]:
        """Per-replica FSM rows (ref: serve state API replicas view)."""
        await self._ensure_loop()
        rows: List[Dict[str, Any]] = []
        for state in self._manager.deployments.values():
            rows.extend(state.replica_rows())
        return rows

    async def graceful_shutdown(self) -> None:
        self._shutdown = True
        for app in list(self._apps):
            await self.delete_application(app)
        # Drain replica teardown.
        deadline = time.time() + 10
        while self._manager.deployments and time.time() < deadline:
            updates = self._manager.reconcile()
            if updates:
                self._long_poll.notify_changed({
                    f"replicas::{dep_id}": replicas
                    for dep_id, replicas in updates.items()
                })
            await asyncio.sleep(0.02)
        # The control loop observes _shutdown only at its next tick; left
        # alone it would be abandoned mid-sleep when the actor's event loop
        # dies, with anything awaiting it unresolved.  Cancel and reap it.
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
            self._loop_task = None
