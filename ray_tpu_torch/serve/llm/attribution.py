"""Per-request / per-token latency attribution for the LLM engine (the
counterpart of ``ray_tpu/serve/llm/attribution.py``).

Every request's time-to-first-token decomposes into named wall-clock
buckets —

- ``queue``      continuous-batch router queue (submit → engine pickup)
- ``admission``  waiting for KV-block headroom (scheduler admit)
- ``prefill``    prompt prefill compute (including preemption recompute)
- ``handoff``    KV-page export/import between prefill and decode pools
- ``residual``   everything unmeasured (RPC hops, event-loop latency)

Construction guarantees the recorded buckets sum to the recorded wall
bit-exactly: buckets are capped cumulatively against the remaining wall
in order, the residual absorbs what is left, and the wall that gets
reported is the split's own sum, taken as ``sum(split.values())`` takes it
(no epsilon slack needed in tests).  Each finalized TTFT lands in
three places: the ``ray_tpu_llm_ttft_seconds`` histogram (trace-ID
exemplars), retroactive ``serve.ttft_<bucket>`` child spans laid
contiguously under the request's trace, and raw value points in the
process ``TimeSeriesAggregator`` so ``serve.metrics.ttft_p99()`` and the
SLO watchdog see exact windowed percentiles, not bucket estimates.

Inter-token gaps record the same way (histogram + aggregator points), and
preemption recompute — prefill re-running tokens the request already
produced — is tagged separately (``serve.preempt_recompute`` spans,
``ray_tpu_llm_recompute_tokens_total``) so goodput vs waste is one query.

``set_enabled(False)`` turns the whole layer off (the engine gates on
``is_enabled()`` before it creates attributions).  Until the engine is
ported (ROADMAP.md, Queue 1 item 13, piece 7) nothing in the port calls
this module on the serving path; the SLO watchdog's latency objectives
read what it records.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve import metrics as _serve_metrics
from ray_tpu_torch.serve.llm import metrics as _m
from ray_tpu_torch.util import tracing as _tracing

#: TTFT bucket names in wall-clock order (the residual is derived).
TTFT_BUCKETS = ("queue", "admission", "prefill", "handoff")

_enabled = True

#: Last finalized TTFTs (test/debug introspection, bounded).
_RECENT_TTFT: collections.deque = collections.deque(maxlen=256)
_recent_lock = threading.Lock()


def set_enabled(flag: bool) -> None:
    """Toggle attribution globally (bench A/B off-switch)."""
    global _enabled
    _enabled = bool(flag)


def is_enabled() -> bool:
    return _enabled


def recent_ttft() -> List[Dict[str, Any]]:
    """Recently finalized TTFT records ({wall, buckets, deployment,
    pool}), oldest first."""
    with _recent_lock:
        return list(_RECENT_TTFT)


def _ltr_sum(split: Dict[str, float]) -> float:
    """The split's sum in bucket order, by the built-in ``sum``: since
    Python 3.12 it adds floats with compensated summation, so a plain
    left-to-right loop can differ from ``sum(split.values())`` in the last
    bit, and the recorded wall must equal that sum exactly."""
    return sum(split[name] for name in (*TTFT_BUCKETS, "residual"))


def split_wall(wall: float, buckets: Dict[str, float]) -> Dict[str, float]:
    """Cap measured buckets cumulatively against ``wall`` (in TTFT_BUCKETS
    order) and derive the residual.  The split sums back to ``wall`` up to
    float dust from the subtraction chain (a couple of ulps — bit-exact
    equality is not generally reachable for a float sum, the rounding grid
    can skip the target).  :func:`record_ttft` therefore re-derives the
    wall it REPORTS from the split (:func:`_ltr_sum`), so the recorded
    buckets sum to the recorded wall bit-exactly while differing from the
    raw clock difference by well under any clock's resolution."""
    out: Dict[str, float] = {}
    wall = max(0.0, float(wall))
    assigned = 0.0
    for name in TTFT_BUCKETS:
        v = min(max(0.0, buckets.get(name, 0.0)), max(0.0, wall - assigned))
        out[name] = v
        assigned += v
    out["residual"] = max(0.0, wall - assigned)
    return out


def _observe_point(name: str, value: float, tags: Dict[str, str]) -> None:
    # Raw per-request points (not the histogram's _sum/_count counters):
    # windowed percentiles over these are exact, which is what the p99
    # accessors and the SLO bad-fraction computation consume.
    from ray_tpu_torch.util.metrics_agent import get_aggregator

    get_aggregator().observe(name, value, tags, kind="value")


def record_ttft(wall: float, buckets: Dict[str, float], *,
                deployment: str, pool: str,
                trace_ctx: Optional[dict] = None,
                start: Optional[float] = None,
                preemptions: int = 0) -> Dict[str, float]:
    """Finalize one request's TTFT: histogram + exemplar, per-bucket
    histogram, aggregator value point, and contiguous ``serve.ttft_*``
    child spans from ``start`` when tracing is on.  Returns the
    construction-verified split; the wall recorded everywhere is the
    split's own sum (:func:`_ltr_sum`), so the buckets sum to it bit-exactly
    (the ulp-level difference from the raw clock delta is far below
    timer resolution)."""
    split = split_wall(wall, buckets)
    wall = _ltr_sum(split)
    tags = {"deployment": deployment, "pool": pool}
    exemplar = _serve_metrics.trace_exemplar(trace_ctx)
    _m.TTFT_SECONDS.observe(wall, tags=tags, exemplar=exemplar)
    for name in (*TTFT_BUCKETS, "residual"):
        if split[name] > 0.0:
            _m.TTFT_BUCKET_SECONDS.observe(
                split[name], tags={"bucket": name, "pool": pool},
                exemplar=exemplar)
    _observe_point("ray_tpu_llm_ttft_seconds", wall, tags)
    if trace_ctx is not None and start is not None \
            and _tracing.is_tracing_enabled():
        t = start
        attrs = {"pool": pool, "preemptions": preemptions}
        for name in (*TTFT_BUCKETS, "residual"):
            if split[name] <= 0.0:
                continue
            _tracing.record_span(f"serve.ttft_{name}", t, t + split[name],
                                 parent=trace_ctx, attributes=attrs)
            t += split[name]
    with _recent_lock:
        _RECENT_TTFT.append({"wall": wall, "buckets": dict(split),
                             "deployment": deployment, "pool": pool})
    return split


def record_gap(gap: float, *, deployment: str, pool: str,
               trace_ctx: Optional[dict] = None) -> None:
    """One inter-token gap (emission N-1 → emission N of a request)."""
    tags = {"deployment": deployment, "pool": pool}
    _m.INTER_TOKEN_SECONDS.observe(
        gap, tags=tags, exemplar=_serve_metrics.trace_exemplar(trace_ctx))
    _observe_point("ray_tpu_llm_inter_token_seconds", gap, tags)


class RequestAttribution:
    """Per-sequence bucket accumulator, attached as ``seq.attrib`` by the
    engine.  ``request_level`` is False for decode-pool sequences resumed
    from a KV handoff (the frontend owns the request-level TTFT there);
    they still contribute pool-tagged inter-token gaps."""

    __slots__ = ("t_submit", "mark", "trace_ctx", "buckets", "pool",
                 "deployment", "request_level", "first_emit_done",
                 "last_emit_t", "preemptions")

    def __init__(self, *, pool: str, deployment: str, t_submit: float,
                 trace_ctx: Optional[dict] = None,
                 request_level: bool = True):
        self.pool = pool
        self.deployment = deployment
        self.t_submit = t_submit
        #: start of the current admission-wait interval — re-armed on
        #: preemption so a requeued sequence never double counts the time
        #: before its FIRST admission.
        self.mark = t_submit
        self.trace_ctx = trace_ctx
        self.buckets: Dict[str, float] = {}
        self.request_level = request_level
        self.first_emit_done = False
        self.last_emit_t = 0.0
        self.preemptions = 0

    def _add(self, bucket: str, dt: float) -> None:
        if dt > 0.0:
            self.buckets[bucket] = self.buckets.get(bucket, 0.0) + dt

    def accumulate(self, bucket: str, dt: float) -> None:
        """Fold an externally measured interval into a named bucket (the
        disagg frontend feeds prefill-worker measurements this way)."""
        if bucket not in TTFT_BUCKETS:
            raise ValueError(f"unknown TTFT bucket {bucket!r}")
        self._add(bucket, float(dt))

    def on_added(self, now: float) -> None:
        """Engine picked the request out of the continuous-batch queue."""
        self._add("queue", now - self.t_submit)
        self.mark = now

    def on_admitted(self, now: float) -> None:
        """Scheduler admitted the sequence (block headroom cleared)."""
        self._add("admission", now - self.mark)

    def on_preempted(self, now: float) -> None:
        """Blocks reclaimed; the sequence is waiting for admission again."""
        self.preemptions += 1
        self.mark = now

    def on_prefill(self, dt: float) -> None:
        self._add("prefill", dt)

    def on_handoff(self, dt: float) -> None:
        self._add("handoff", dt)

    def on_recompute(self, dt: float, tokens: int, now: float) -> None:
        """Prefill re-ran ``tokens`` already-generated tokens after a
        preemption — counted as prefill for the TTFT split, tagged as
        waste for goodput accounting, and visible as its own span so a
        long inter-token gap explains itself in the timeline."""
        self._add("prefill", dt)
        if tokens > 0:
            _m.RECOMPUTE_TOKENS.inc(tokens, tags={"pool": self.pool})
        if self.trace_ctx is not None and _tracing.is_tracing_enabled():
            _tracing.record_span(
                "serve.preempt_recompute", now - dt, now,
                parent=self.trace_ctx,
                attributes={"tokens": tokens, "pool": self.pool})

    def on_emit(self, now: float) -> None:
        """One token reached the output stream."""
        if not self.first_emit_done:
            self.first_emit_done = True
            if self.request_level:
                record_ttft(now - self.t_submit, self.buckets,
                            deployment=self.deployment, pool=self.pool,
                            trace_ctx=self.trace_ctx, start=self.t_submit,
                            preemptions=self.preemptions)
        else:
            record_gap(now - self.last_emit_t, deployment=self.deployment,
                       pool=self.pool, trace_ctx=self.trace_ctx)
        self.last_emit_t = now
