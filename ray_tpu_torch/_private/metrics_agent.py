"""Per-process metrics agent: runtime gauges and an HTTP endpoint (the
counterpart of ``ray_tpu/_private/metrics_agent.py``; ref:
_private/metrics_agent.py:483 + _private/prometheus_exporter.py).

It samples the runtime's state into gauges (the role of the C++
`stats/metric_defs.cc` core metrics) and serves, over HTTP:

- ``/metrics``: the whole registry (internal + user metrics,
  util/metrics.py) in Prometheus text format;
- ``/timeseries``: the process aggregator's windowed rollups
  (util/metrics_agent.py) as OpenMetrics text;
- ``/api/tasks``, ``/api/actors``, ``/api/objects``, ``/api/nodes``,
  ``/api/placement_groups``, ``/api/train_runs``: the state API's rows
  (util/state);
- ``/api/postmortems``, ``/api/postmortems/<id>``,
  ``/api/postmortems/bundle``: the flight-recorder dumps' index, one dump,
  and the merged bundle (util/forensics.py);
- ``/api/jobs``: the submitted jobs (job/job_manager.py);
- ``/api/serve``: deployment and replica rows from the serve controller;
- ``/api/serve/slo``: one fresh SLO watchdog evaluation (serve/slo.py);
- ``/api/stacks`` and ``/api/memory``: the thread stacks of this process
  and of every process worker (``stack_profiler.collect_all_stacks``), and
  this process's tracemalloc heap summary.

The reference's cluster and node pages (``/api/cluster``,
``/api/node/<id>``) answer 404 until the port has its nodes (ROADMAP.md,
Queue 1 item 13.8).  One agent per runtime, started on demand.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ray_tpu_torch.util import metrics as um

_INTERNAL: Optional[dict] = None
_LOCK = threading.Lock()


def _internal_gauges() -> dict:
    global _INTERNAL
    with _LOCK:
        if _INTERNAL is None:
            _INTERNAL = {
                "tasks_finished": um.Counter(
                    "ray_tpu_tasks_finished_total", "tasks finished OK"),
                "tasks_failed": um.Counter(
                    "ray_tpu_tasks_failed_total", "tasks failed"),
                "object_store_bytes": um.Gauge(
                    "ray_tpu_object_store_bytes",
                    "bytes of arrays, tensors and byte strings in the "
                    "object store"),
                "object_store_capacity": um.Gauge(
                    "ray_tpu_object_store_capacity_bytes",
                    "the node's memory resource"),
                "objects": um.Gauge(
                    "ray_tpu_objects", "objects tracked", ("state",)),
                "actors": um.Gauge(
                    "ray_tpu_actors", "actors by state", ("state",)),
                "pending_tasks": um.Gauge(
                    "ray_tpu_pending_tasks", "tasks waiting for dispatch"),
                "nodes": um.Gauge("ray_tpu_nodes", "cluster nodes"),
            }
        return _INTERNAL


def record_task_finished(ok: bool) -> None:
    g = _internal_gauges()
    (g["tasks_finished"] if ok else g["tasks_failed"]).inc()


def sample_runtime(runtime) -> None:
    """Refresh the internal gauges from live runtime state."""
    g = _internal_gauges()
    g["object_store_bytes"].set(runtime.store.bytes_used())
    g["object_store_capacity"].set(
        runtime.cluster_resources().get("memory", 0.0))
    by_state: dict = {}
    for info in runtime.store.object_summaries():
        by_state[info["state"]] = by_state.get(info["state"], 0) + 1
    g["objects"].clear()  # states whose count dropped to 0 must not linger
    for state, n in by_state.items():
        g["objects"].set(n, {"state": state})
    actor_states: dict = {}
    for a in runtime.list_actor_states():
        actor_states[a["state"]] = actor_states.get(a["state"], 0) + 1
    g["actors"].clear()
    for state, n in actor_states.items():
        g["actors"].set(n, {"state": state})
    g["pending_tasks"].set(len(runtime._inflight))
    g["nodes"].set(len(runtime.nodes()))


class MetricsAgent:
    """HTTP scrape endpoint over the process registry (``port=0`` picks a
    free port; read it from ``.port``)."""

    def __init__(self, runtime, port: int = 0, host: str = "127.0.0.1"):
        self._runtime = runtime

        agent = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0].rstrip("/")
                try:
                    if path == "/metrics":
                        sample_runtime(agent._runtime)
                        self._send(um.registry().prometheus_text().encode(),
                                   "text/plain; version=0.0.4; charset=utf-8")
                        return
                    if path == "/timeseries":
                        # Each scrape samples the registry into the process
                        # aggregator, so the window fills at scrape cadence.
                        sample_runtime(agent._runtime)
                        from ray_tpu_torch.util.metrics_agent import \
                            get_aggregator

                        agg = get_aggregator()
                        agg.sample_registry()
                        self._send(
                            agg.openmetrics_text().encode(),
                            "application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")
                        return
                    if path.startswith("/api"):
                        payload = _api_payload(path)
                        if payload is None:
                            self.send_error(404)
                            return
                        self._send(json.dumps(payload, default=str).encode(),
                                   "application/json")
                        return
                    self.send_error(404)
                except Exception as e:  # a scrape must never kill the server
                    self.send_error(500, str(e))

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="ray_tpu_metrics_agent",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


def _api_payload(path: str):
    """JSON views (ref: dashboard state_head.py:47 — the same rows `ray list
    ...` prints — and serve_head.py); None for a route the port does not
    serve yet."""
    from ray_tpu_torch.util import state as state_api

    listings = {
        "/api/tasks": state_api.list_tasks,
        "/api/actors": state_api.list_actors,
        "/api/objects": state_api.list_objects,
        "/api/nodes": state_api.list_nodes,
        "/api/placement_groups": state_api.list_placement_groups,
        "/api/train_runs": state_api.list_train_runs,
        "/api/postmortems": state_api.list_postmortems,
    }
    fn = listings.get(path)
    if fn is not None:
        return fn()
    if path == "/api/postmortems/bundle":
        # Full postmortem: every dump merged with the recent time-series
        # window and the run registry.
        from ray_tpu_torch.util import forensics

        return forensics.build_bundle()
    if path.startswith("/api/postmortems/"):
        from ray_tpu_torch.util import forensics

        return forensics.load_postmortem(path[len("/api/postmortems/"):])
    if path == "/api/jobs":
        import importlib

        # By module path: the package's ``job_manager`` is the function,
        # which hides the module of the same name from ``import ... as``
        # (the reference's route reads the function and answers 500).
        jm_mod = importlib.import_module("ray_tpu_torch.job.job_manager")
        mgr = jm_mod._MANAGER  # peek, never create on a GET
        if mgr is None:
            return []
        return [dict(job_id=j.job_id, status=j.status,
                     entrypoint=j.entrypoint, log_path=j.log_path)
                for j in mgr.list_jobs()]
    if path == "/api/serve":
        return _serve_payload()
    if path == "/api/serve/slo":
        # One fresh watchdog evaluation per scrape: burn rates, alert
        # state and windows for every registered objective.
        from ray_tpu_torch.serve import slo as _slo

        watchdog = _slo.get_watchdog()
        return {
            "objectives_registry": sorted(_slo.SLO_OBJECTIVES),
            "deployments": watchdog.evaluate(),
        }
    if path == "/api/stacks":
        from ray_tpu_torch._private import stack_profiler

        return stack_profiler.collect_all_stacks()
    if path == "/api/memory":
        from ray_tpu_torch._private import heap_profiler

        return heap_profiler.heap_summary()
    return None


def _serve_payload() -> dict:
    """Everything the serve dashboard view needs in one fetch: deployment
    rows (status + p50/p95/p99 rollups), replica FSM rows, applications;
    empty rows when serve is not running."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.api import _CONTROL_TIMEOUT_S, _CONTROLLER_NAME

    try:
        controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:
        deployments, replicas = [], []
    else:
        deployments = ray_tpu_torch.get(controller.list_deployments.remote(),
                                        timeout=_CONTROL_TIMEOUT_S)
        replicas = ray_tpu_torch.get(controller.list_replicas.remote(),
                                     timeout=_CONTROL_TIMEOUT_S)
    apps = sorted({d["app"] for d in deployments})
    return {
        "applications": apps,
        "num_deployments": len(deployments),
        "num_replicas": len(replicas),
        "deployments": deployments,
        "replicas": replicas,
    }
