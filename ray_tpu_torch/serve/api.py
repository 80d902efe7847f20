"""Serve public API — @deployment, bind/run, handles (the counterpart of
``ray_tpu/serve/api.py``).

(ref: python/ray/serve/api.py — serve.deployment decorator, serve.run;
app graph built via .bind() (build_app.py) with nested deployments turned
into DeploymentHandles at deploy time.)
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, HTTPOptions
from ray_tpu_torch.serve.handle import DeploymentHandle

_CONTROLLER_NAME = "SERVE_CONTROLLER"
#: Bound on one call to the controller: a wedged control plane raises
#: GetTimeoutError instead of hanging its caller.
_CONTROL_TIMEOUT_S = 60.0
_lock = threading.Lock()
_state: Dict[str, Any] = {"controller": None, "proxy": None}


# ---------------------------------------------------------------- deployment
class Deployment:
    """The decorated, not-yet-bound deployment (ref: serve/deployment.py
    Deployment)."""

    def __init__(self, func_or_class: Any, name: str, config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[Union[int, str]] = None,
                max_ongoing_requests: Optional[int] = None,
                max_queued_requests: Optional[int] = None,
                user_config: Optional[Any] = None,
                autoscaling_config: Optional[Union[AutoscalingConfig, Dict]] = None,
                ray_actor_options: Optional[Dict] = None,
                health_check_period_s: Optional[float] = None,
                health_check_timeout_s: Optional[float] = None,
                graceful_shutdown_wait_loop_s: Optional[float] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                max_unavailable: Optional[int] = None,
                compiled_route: Optional[bool] = None) -> "Deployment":
        import copy

        cfg = copy.deepcopy(self.config)
        if num_replicas == "auto":
            # "auto" means autoscaled: wire a default AutoscalingConfig when
            # the caller did not pass one, instead of silently keeping the
            # static num_replicas.
            if autoscaling_config is None and cfg.autoscaling_config is None:
                cfg.autoscaling_config = AutoscalingConfig.default()
        elif num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if user_config is not None:
            cfg.user_config = user_config
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if health_check_timeout_s is not None:
            cfg.health_check_timeout_s = health_check_timeout_s
        if graceful_shutdown_wait_loop_s is not None:
            cfg.graceful_shutdown_wait_loop_s = graceful_shutdown_wait_loop_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if max_unavailable is not None:
            cfg.max_unavailable = max_unavailable
        if compiled_route is not None:
            cfg.compiled_route = compiled_route
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "Deployments cannot be called directly; use .bind() + serve.run, "
            "then handle.remote() (ref: serve deployment calling contract)")


@dataclass
class Application:
    """A bound (sub)graph of deployments (ref: serve Application /
    build_app.py BuiltApplication)."""

    deployment: Deployment
    args: tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


def deployment(_func_or_class: Optional[Any] = None, *,
               name: Optional[str] = None,
               num_replicas: Union[int, str, None] = None,
               max_ongoing_requests: int = 5,
               max_queued_requests: int = -1,
               user_config: Optional[Any] = None,
               autoscaling_config: Optional[Union[AutoscalingConfig, Dict]] = None,
               ray_actor_options: Optional[Dict] = None,
               health_check_period_s: float = 10.0,
               health_check_timeout_s: float = 30.0,
               graceful_shutdown_wait_loop_s: float = 2.0,
               graceful_shutdown_timeout_s: float = 5.0,
               max_unavailable: int = 0,
               compiled_route: Optional[bool] = None) -> Any:
    """@serve.deployment (ref: serve/api.py:deployment)."""

    def decorate(obj):
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        if num_replicas == "auto" and asc is None:
            asc = AutoscalingConfig.default()
        cfg = DeploymentConfig(
            num_replicas=(num_replicas if isinstance(num_replicas, int) else 1),
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            user_config=user_config,
            autoscaling_config=asc,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_wait_loop_s=graceful_shutdown_wait_loop_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            max_unavailable=max_unavailable,
            compiled_route=compiled_route,
            ray_actor_options=dict(ray_actor_options or {}))
        return Deployment(obj, name or obj.__name__, cfg)

    if _func_or_class is not None:
        return decorate(_func_or_class)
    return decorate


# ------------------------------------------------------------------ runtime
def _get_controller():
    with _lock:
        if _state["controller"] is None:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            try:
                _state["controller"] = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
            except ValueError:  # no controller yet
                from ray_tpu_torch.serve.controller import ServeController

                # High max_concurrency: parked long-poll listens from every
                # router/proxy share this actor's loop and must not serialize
                # behind each other (ref: controller.py — async controller).
                _state["controller"] = (
                    ray_tpu_torch.remote(ServeController)
                    .options(name=_CONTROLLER_NAME, lifetime="detached",
                             max_concurrency=1000)
                    .remote())
        return _state["controller"]


def start(http_options: Optional[Union[HTTPOptions, Dict]] = None,
          detached: bool = True) -> None:
    """Start the Serve instance: controller + HTTP proxy (ref: serve/api.py
    start). Raises if the proxy cannot bind its port."""
    controller = _get_controller()
    with _lock:
        if _state["proxy"] is not None:
            return
        if isinstance(http_options, dict):
            http_options = HTTPOptions(**http_options)
        from ray_tpu_torch.serve.proxy import HTTPProxy

        proxy = HTTPProxy(controller, http_options or HTTPOptions())
        proxy.start()
        _state["proxy"] = proxy


def _build_app(app: Application, app_name: str) -> tuple:
    """Flatten the bind graph into deployment descriptors; nested
    Applications become DeploymentHandles (ref: build_app.py build_app)."""
    deployments: Dict[str, Dict[str, Any]] = {}

    def visit(node: Application) -> DeploymentHandle:
        dep = node.deployment

        def convert(v):
            return visit(v) if isinstance(v, Application) else v

        args = tuple(convert(a) for a in node.args)
        kwargs = {k: convert(v) for k, v in node.kwargs.items()}
        existing = deployments.get(dep.name)
        desc = {"name": dep.name, "deployment_def": dep.func_or_class,
                "init_args": args, "init_kwargs": kwargs, "config": dep.config}
        if existing is None:
            deployments[dep.name] = desc
        return DeploymentHandle(dep.name, app_name)

    ingress_handle = visit(app)
    return list(deployments.values()), app.deployment.name, ingress_handle


def _ingress_streams(deployment_def) -> bool:
    """Does the ingress __call__ stream (generator/async-generator)?  The
    proxies then iterate the response instead of buffering it (ref:
    proxy.py:532 — the reference streams ASGI responses the same way)."""
    import inspect

    fn = deployment_def
    if inspect.isclass(deployment_def):
        fn = getattr(deployment_def, "__call__", None)
    return bool(fn) and (inspect.isgeneratorfunction(fn)
                         or inspect.isasyncgenfunction(fn))


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy an application and wait for it to be ready
    (ref: serve/api.py run / _run)."""
    controller = _get_controller()
    descs, ingress_name, handle = _build_app(app, name)
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix, ingress_name, descs,
        ingress_streaming=_ingress_streams(app.deployment.func_or_class)),
        timeout=_CONTROL_TIMEOUT_S)
    _wait_for_application(name, timeout_s=60.0)
    if blocking:  # pragma: no cover - interactive mode
        import time as _t

        while True:
            _t.sleep(1)
    return handle


def _wait_for_application(app_name: str, timeout_s: float) -> None:
    """Waits until every deployment of the app is HEALTHY. A replica that
    failed to start fails the wait at once with its cause: the reconciler
    would retry it after a backoff, but serve.run does not wait for a
    replica that cannot construct (or, asking for a GPU, cannot be placed
    on a host without one)."""
    import time

    controller = _get_controller()
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        status = ray_tpu_torch.get(controller.get_deployment_status.remote(),
                                   timeout=_CONTROL_TIMEOUT_S)
        app_deps = {k: v for k, v in status.items()
                    if k.startswith(f"{app_name}#")}
        if app_deps and all(v["status"] == "HEALTHY" for v in app_deps.values()):
            return
        failed = {k: v["last_start_error"] for k, v in app_deps.items()
                  if v["status"] != "HEALTHY" and v["last_start_error"]}
        if failed:
            raise RuntimeError(
                f"Application {app_name!r} failed to start: {failed}")
        time.sleep(0.05)
    raise TimeoutError(f"Application {app_name!r} not healthy in {timeout_s}s")


def get_app_handle(name: str = "default") -> DeploymentHandle:
    """(ref: serve/api.py get_app_handle)"""
    controller = _get_controller()
    app = ray_tpu_torch.get(controller.get_app_config.remote(name),
                            timeout=_CONTROL_TIMEOUT_S)
    if app is None:
        raise ValueError(f"Application {name!r} does not exist")
    return DeploymentHandle(app["ingress"], name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def pipeline(*stages, methods: Optional[list] = None,
             devices: Optional[list] = None, name: str = "pipeline"):
    """Chain deployments into a multi-stage compiled serve graph
    (:class:`~ray_tpu_torch.serve.compiled_router.ServePipeline`).

    ``pipeline(prefill, decode, postprocess).remote(x)`` submits ``x`` to
    the first stage and returns a future that resolves with the LAST
    stage's result; once every stage's replica set is stable and compiled,
    the request traverses the whole chain as typed-channel traffic —
    stage i's demux forwards straight into stage i+1's lanes over a
    ``DeviceChannel`` edge, no TaskSpec or ObjectRef between stages.

    Stages are deployment names (looked up via ``get_deployment_handle``),
    handles, or method-bound handles (``handle.method``); ``methods``
    overrides the called method per stage, ``devices`` (one per edge)
    places each inter-stage payload's tensors on the consumer's device at
    forward time (``"cuda"``, ``"cpu"``, or None to leave them).  Any
    stage membership change degrades that hop to dynamic dispatch with
    zero caller-visible errors and re-lowers when the stage recompiles."""
    from ray_tpu_torch.serve.compiled_router import ServePipeline

    handles = [get_deployment_handle(s) if isinstance(s, str) else s
               for s in stages]
    return ServePipeline(handles, methods=methods, devices=devices,
                         name=name)


def status() -> Dict[str, Any]:
    """Per-deployment status INCLUDING the RED latency rollup: replica
    counts/health plus requests/errors and p50/p95/p99/mean end-to-end
    latency (ms) aggregated from every router's pushed snapshots.  When
    the SLO watchdog (serve/slo.py) has objectives registered, each
    deployment row also carries its fresh ``"slo"`` evaluation, and each
    row carries this process's device-telemetry rollup under ``"device"``
    (named pool bytes + windowed h2d/d2h transfer bandwidth)."""
    controller = _get_controller()
    out = ray_tpu_torch.get(controller.get_deployment_status.remote(),
                            timeout=_CONTROL_TIMEOUT_S)
    from ray_tpu_torch.serve import slo as _slo

    watchdog = _slo.get_watchdog()
    if watchdog.has_objectives():
        slo_payload = watchdog.evaluate()
        for dep_id, row in out.items():
            # Objectives may be keyed by the full "app#name" id or the
            # bare deployment name — match either.
            for key in (dep_id, dep_id.split("#", 1)[-1]):
                if key in slo_payload:
                    row["slo"] = slo_payload[key]
                    break
    try:
        from ray_tpu_torch.util import device_telemetry as _dt

        device_info: Optional[Dict[str, Any]] = {
            "pools": _dt.pool_bytes(),
            "transfer_bw": {"h2d": _dt.transfer_bw("h2d"),
                            "d2h": _dt.transfer_bw("d2h")},
        }
    except Exception:  # status must never break on a telemetry hiccup
        device_info = None
    if device_info is not None:
        for row in out.values():
            row["device"] = device_info
    return out


def list_deployments() -> list:
    """Deployment observability rows (status + route + inflight + RED
    rollups)."""
    controller = _get_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote(),
                             timeout=_CONTROL_TIMEOUT_S)


def list_replicas() -> list:
    """Per-replica FSM rows (state, version, uptime, health counters)."""
    controller = _get_controller()
    return ray_tpu_torch.get(controller.list_replicas.remote(),
                             timeout=_CONTROL_TIMEOUT_S)


def delete(name: str, _blocking: bool = True) -> None:
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name),
                      timeout=_CONTROL_TIMEOUT_S)


def shutdown() -> None:
    """(ref: serve/api.py shutdown)"""
    with _lock:
        controller = _state["controller"]
        proxy = _state["proxy"]
        _state["controller"] = None
        _state["proxy"] = None
    if proxy is not None:
        proxy.stop()
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=15.0)
            ray_tpu_torch.kill(controller)
        except Exception:  # noqa: BLE001 — the runtime may be gone already
            pass
