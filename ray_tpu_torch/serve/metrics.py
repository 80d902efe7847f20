"""Per-deployment RED metrics for the serve data plane (the counterpart of
``ray_tpu/serve/metrics.py``).

(ref: python/ray/serve/_private/metrics_utils.py + the replica/router
metric surfaces — serve_deployment_request_counter,
serve_deployment_processing_latency_ms, etc.)  One module owns every serve
request metric so names, labels, and units stay consistent across the
proxy, router and replica layers:

- ``serve_request_latency_seconds``   Histogram, end-to-end handle-call
  latency per deployment (assign -> reply), trace-ID exemplars.
- ``serve_queue_wait_seconds``        Histogram, time a request waited in
  a batch queue (or a continuous-batching admission queue) before its
  vectorized call began.
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
:func:`ray_tpu_torch.util.metrics.percentile_from_buckets`.  The windowed
accessors (request rate, the LLM views) read the process
:class:`~ray_tpu_torch.util.metrics_agent.TimeSeriesAggregator`.
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
QUEUE_WAIT = _metrics.Histogram(
    "serve_queue_wait_seconds",
    "Time a request waited in a batch queue before execution began",
    boundaries=LATENCY_BOUNDARIES,
    tag_keys=("deployment", "method"))
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


def process_totals() -> Dict[str, Dict[str, float]]:
    """Per-deployment request/error totals as counted by THIS process —
    the cheap serve row the per-node dashboard summaries embed."""
    out: Dict[str, Dict[str, float]] = {}
    for _, tags, value in REQUESTS_TOTAL.samples():
        dep = tags.get("deployment", "")
        out.setdefault(dep, {"requests": 0.0, "errors": 0.0})
        out[dep]["requests"] += value
    for _, tags, value in ERRORS_TOTAL.samples():
        dep = tags.get("deployment", "")
        out.setdefault(dep, {"requests": 0.0, "errors": 0.0})
        out[dep]["errors"] += value
    return out


def request_rate(deployment: str, window_s: float = 60.0,
                 now: Optional[float] = None) -> float:
    """Requests/second for a deployment over the trailing window, from the
    process-wide TimeSeriesAggregator (util/metrics_agent.py) — the signal
    the target-qps autoscaling policy scales on.  The
    aggregator must be fed on a cadence (the agent's ``/timeseries`` scrape
    or an explicit ``sample_registry()``); returns 0.0 before any samples
    land — cold start reads as "no traffic", never an error."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    return agg.window_rate("serve_requests_total",
                           {"deployment": deployment}, window_s, now)


# ----------------------------------------------------- LLM windowed view
# Accessors over the attribution layer's raw per-request points
# (serve/llm/attribution.py feeds the process aggregator directly), shaped
# for the autoscaler and the SLO watchdog: exact windowed percentiles, not
# histogram-bucket estimates.  The engine series (KV blocks, occupancy,
# decode, speculation, prefix cache) read 0.0 until the LLM engine lands
# (ROADMAP.md, Queue 1 item 13), as they do before any point lands.  Deployment tags on LLM
# series use the bare replica-context name; callers holding a full
# "app#name" id fall back to the name part automatically.


def _dep_tag_candidates(deployment: Optional[str]):
    if not deployment:
        return (None,)
    if "#" in deployment:
        return ({"deployment": deployment},
                {"deployment": deployment.split("#", 1)[1]})
    return ({"deployment": deployment},)


def _windowed_percentile(name: str, q: float, deployment: Optional[str],
                         window_s: float, now: Optional[float]) -> float:
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    for tags in _dep_tag_candidates(deployment):
        vals = sorted(agg.window_values(name, tags, window_s, now))
        if vals:
            rank = min(len(vals) - 1,
                       int(round((q / 100.0) * (len(vals) - 1))))
            return vals[rank]
    return 0.0


def ttft_p99(deployment: Optional[str] = None, window_s: float = 60.0,
             now: Optional[float] = None, q: float = 99.0) -> float:
    """Windowed time-to-first-token percentile (seconds) across every
    request the attribution layer finalized; 0.0 before any land."""
    return _windowed_percentile("ray_tpu_llm_ttft_seconds", q, deployment,
                                window_s, now)


def inter_token_p99(deployment: Optional[str] = None,
                    window_s: float = 60.0, now: Optional[float] = None,
                    q: float = 99.0) -> float:
    """Windowed inter-token-gap percentile (seconds)."""
    return _windowed_percentile("ray_tpu_llm_inter_token_seconds", q,
                                deployment, window_s, now)


def _pool_tags(pool: Optional[str]) -> Optional[Dict[str, str]]:
    return {"pool": pool} if pool else None


def kv_utilization(pool: Optional[str] = None, window_s: float = 60.0,
                   now: Optional[float] = None) -> float:
    """Windowed mean KV-block utilization (in-use / total, 0..1) for one
    pool or (subset rollup) across all pools."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    tags = _pool_tags(pool)
    total = agg.window_rate("ray_tpu_llm_kv_blocks_total", tags,
                            window_s, now)
    if total <= 0.0:
        return 0.0
    in_use = agg.window_rate("ray_tpu_llm_kv_blocks_in_use", tags,
                             window_s, now)
    return in_use / total


def batch_occupancy(pool: Optional[str] = None, window_s: float = 60.0,
                    now: Optional[float] = None) -> float:
    """Windowed mean continuous-batch fill fraction (0..1)."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    return agg.window_rate("ray_tpu_llm_batch_occupancy", _pool_tags(pool),
                           window_s, now)


def goodput_tokens_per_s(pool: Optional[str] = None,
                         window_s: float = 60.0,
                         now: Optional[float] = None) -> float:
    """Decode tokens actually emitted per second over the window."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    return agg.window_rate("ray_tpu_llm_decode_tokens_total",
                           _pool_tags(pool), window_s, now)


def acceptance_rate(pool: Optional[str] = None, window_s: float = 60.0,
                    now: Optional[float] = None) -> float:
    """Windowed speculative-decoding acceptance: draft tokens the target
    verification accepted over draft tokens proposed, 0..1 across every
    stream in the pool (per-stream tallies live on ``Sequence.spec_*``).
    Returns 0.0 when spec decode is off or no proposals landed in the
    window — cold start reads as "no speculation", never an error."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    tags = _pool_tags(pool)
    proposed = agg.window_rate("ray_tpu_llm_spec_proposed_tokens_total",
                               tags, window_s, now)
    if proposed <= 0.0:
        return 0.0
    accepted = agg.window_rate("ray_tpu_llm_spec_accepted_tokens_total",
                               tags, window_s, now)
    return min(1.0, accepted / proposed)


def prefix_hit_rate(pool: Optional[str] = None, window_s: float = 60.0,
                    now: Optional[float] = None) -> float:
    """Windowed prefix-cache hit rate: prompt tokens served from cached
    blocks (or promoted tier pages) over full-block prompt tokens looked
    up, 0..1 across the pool's prefills.  Returns 0.0 when the cache is
    off or no lookups landed in the window — cold start reads as "no
    reuse", never an error."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    tags = _pool_tags(pool)
    lookup = agg.window_rate("ray_tpu_llm_prefix_lookup_tokens_total",
                             tags, window_s, now)
    if lookup <= 0.0:
        return 0.0
    hit = agg.window_rate("ray_tpu_llm_prefix_hit_tokens_total",
                          tags, window_s, now)
    return min(1.0, hit / lookup)


def recompute_waste_tokens_per_s(pool: Optional[str] = None,
                                 window_s: float = 60.0,
                                 now: Optional[float] = None) -> float:
    """Tokens re-prefilled after preemption/recovery per second — the
    waste term against :func:`goodput_tokens_per_s`."""
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    agg = get_aggregator()
    agg.sample_registry()
    return agg.window_rate("ray_tpu_llm_recompute_tokens_total",
                           _pool_tags(pool), window_s, now)


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
