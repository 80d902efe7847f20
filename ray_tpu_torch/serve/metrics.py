"""Per-deployment RED metrics for the serve data plane (the counterpart of
``ray_tpu/serve/metrics.py``).

(ref: python/ray/serve/_private/metrics_utils.py + the replica/router
metric surfaces — serve_deployment_request_counter,
serve_deployment_processing_latency_ms, etc.)  One module owns every serve
request metric so names, labels, and units stay consistent across the
proxy, router and replica layers:

- ``serve_request_latency_seconds``   Histogram, end-to-end handle-call
  latency per deployment (assign -> reply), trace-ID exemplars.
- ``serve_execution_seconds``         Histogram, user-callable execution
  time.
- ``serve_requests_total``            Counter, completed handle calls.
- ``serve_request_errors_total``      Counter, handle calls that raised.
- ``serve_http_inflight``             Gauge, HTTP requests currently inside
  the proxy handler.

Routers push cumulative per-deployment snapshots of these to the
controller keyed by ``(router_id, pid)``; the controller sums the latest
snapshot per pid (routers in one process share the process-global
registry, so summing per-router would double count) and folds them into
``serve.status()`` rollups via
:func:`ray_tpu_torch.util.metrics.percentile_from_buckets`.
The batch queue's wait histogram comes with ``serve.batch``, the windowed
accessors (request rate, the LLM views) with the metrics agent (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

#: Request-latency buckets: 1 ms .. 60 s (sub-ms inference replies land in
#: the first bucket; anything past 60 s hit the handle timeout anyway).
LATENCY_BOUNDARIES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                      0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

REQUEST_LATENCY = _metrics.Histogram(
    "serve_request_latency_seconds",
    "End-to-end request latency per deployment (handle assign to reply)",
    boundaries=LATENCY_BOUNDARIES,
    tag_keys=("deployment",))
EXECUTION = _metrics.Histogram(
    "serve_execution_seconds",
    "User-callable execution time per (possibly vectorized) invocation",
    boundaries=LATENCY_BOUNDARIES,
    tag_keys=("deployment", "method"))
REQUESTS_TOTAL = _metrics.Counter(
    "serve_requests_total",
    "Completed requests per deployment (errors included)",
    tag_keys=("deployment",))
ERRORS_TOTAL = _metrics.Counter(
    "serve_request_errors_total",
    "Requests per deployment that finished with an error",
    tag_keys=("deployment",))
HTTP_INFLIGHT = _metrics.Gauge(
    "serve_http_inflight",
    "HTTP requests currently being handled by this node's proxy",
    tag_keys=("route",))


def trace_exemplar(ctx: Optional[dict] = None) -> Optional[Dict[str, str]]:
    """Exemplar labels for the active (or given) trace context, or None
    when tracing is off — histogram observations attach these so a latency
    bucket links back to a concrete trace (OpenMetrics exemplars)."""
    if ctx is None:
        # Zero-alloc read of the active span dict — it carries trace_id
        # directly, so no {"trace_id", "span_id"} projection is built.
        ctx = _tracing.active_span()
    if not ctx:
        return None
    return {"trace_id": ctx["trace_id"]}


def deployment_snapshot(deployment: str) -> Dict[str, Any]:
    """Cumulative RED snapshot for one deployment as seen by THIS process
    (what a router pushes to the controller every metrics interval)."""
    return {
        "latency": REQUEST_LATENCY.get(tags={"deployment": deployment}),
        "requests": REQUESTS_TOTAL.get(tags={"deployment": deployment}),
        "errors": ERRORS_TOTAL.get(tags={"deployment": deployment}),
    }


def merge_snapshots(snapshots: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum cumulative per-pid snapshots (bucket counts element-wise)."""
    boundaries = list(LATENCY_BOUNDARIES)
    counts = [0] * (len(boundaries) + 1)
    total = 0
    lat_sum = 0.0
    requests = 0.0
    errors = 0.0
    for snap in snapshots:
        if not snap:
            continue
        lat = snap.get("latency") or {}
        b = lat.get("boundaries")
        c = lat.get("counts") or []
        if b and list(b) == boundaries and len(c) == len(counts):
            counts = [x + y for x, y in zip(counts, c)]
        total += int(lat.get("count", 0))
        lat_sum += float(lat.get("sum", 0.0))
        requests += float(snap.get("requests", 0.0))
        errors += float(snap.get("errors", 0.0))
    return {"boundaries": boundaries, "counts": counts, "count": total,
            "sum": lat_sum, "requests": requests, "errors": errors}


def rollup(snapshots: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """p50/p95/p99 + request/error totals from per-pid snapshots — the
    serve.status() / /api/serve latency rollup."""
    m = merge_snapshots(snapshots)
    pct = lambda q: round(_metrics.percentile_from_buckets(  # noqa: E731
        m["boundaries"], m["counts"], q) * 1000.0, 3)
    mean_ms = (m["sum"] / m["count"] * 1000.0) if m["count"] else 0.0
    return {
        "requests": int(m["requests"]),
        "errors": int(m["errors"]),
        "p50_latency_ms": pct(50),
        "p95_latency_ms": pct(95),
        "p99_latency_ms": pct(99),
        "mean_latency_ms": round(mean_ms, 3),
    }
