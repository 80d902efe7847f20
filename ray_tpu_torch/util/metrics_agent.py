"""Time-series rollups over the metrics registry (the counterpart of
``ray_tpu/util/metrics_agent.py``).

The Counter/Gauge/Histogram registry (`ray_tpu_torch.util.metrics`) answers
"what is the value now"; this module answers "what happened over the last
N seconds" — the question autoscalers and dashboards actually ask.  A
:class:`TimeSeriesAggregator` keeps a per-series sliding window of
timestamped points (bounded: old points are pruned as new ones land) and
derives windowed sums and rates from them, and hands out the raw points
(``window_values``: the SLO watchdog's exact bad fractions):

* ``sample_registry()`` snapshots every counter/gauge/histogram series in
  the process registry into the window — call it on a cadence (the
  metrics agent's ``/timeseries`` route does this per scrape).
* ``window_rate(name, tags, window_s)`` is the query the serve
  autoscaler's target-qps policy consumes (request *rates*, not
  cumulative totals).  Counter series rate by
  positive deltas — process restarts (a total falling back toward zero)
  never produce negative rates.
* ``snapshot()`` / ``merge_snapshot()`` move windows between processes:
  each node's aggregator ships its recent points to the head-side
  :class:`TimeSeriesCollector` actor, which answers cluster-wide queries
  and serves the merged window as OpenMetrics text.

Timestamps are caller-suppliable everywhere (``ts=``/``now=``) so tests
drive a fully deterministic feed.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.util import metrics as _metrics

#: Series key: (metric name, sorted tag items).
_SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]

#: Default retention: queries beyond this window see a truncated view.
DEFAULT_MAX_WINDOW_S = 600.0
#: Per-series point cap — a mis-cadenced sampler cannot grow one series
#: without bound inside the retention window.
_MAX_POINTS = 4096


class _Series:
    __slots__ = ("name", "tags", "kind", "ts", "values")

    def __init__(self, name: str, tags: Dict[str, str], kind: str):
        self.name = name
        self.tags = dict(tags)
        self.kind = kind  # "counter" (cumulative total) | "value" | "gauge"
        self.ts: List[float] = []
        self.values: List[float] = []

    def add(self, ts: float, value: float, horizon: float) -> None:
        # Points may arrive slightly out of order across threads; keep the
        # arrays sorted so window queries can bisect.
        if self.ts and ts < self.ts[-1]:
            i = bisect.bisect_right(self.ts, ts)
            self.ts.insert(i, ts)
            self.values.insert(i, value)
        else:
            self.ts.append(ts)
            self.values.append(value)
        # Prune past the horizon, keeping ONE point before it: counter
        # rates need a baseline sample older than the window start.
        cut = bisect.bisect_left(self.ts, horizon)
        if cut > 1:
            del self.ts[: cut - 1]
            del self.values[: cut - 1]
        if len(self.ts) > _MAX_POINTS:
            drop = len(self.ts) - _MAX_POINTS
            del self.ts[:drop]
            del self.values[:drop]

    def window(self, start: float) -> Tuple[List[float], List[float]]:
        """(ts, values) at or after ``start``, plus one baseline point
        before it when available (index 0 then predates the window)."""
        i = bisect.bisect_left(self.ts, start)
        if i > 0:
            i -= 1
        return self.ts[i:], self.values[i:]


class TimeSeriesAggregator:
    """Per-process sliding-window store of metric points (see module doc)."""

    def __init__(self, max_window_s: float = DEFAULT_MAX_WINDOW_S):
        self.max_window_s = float(max_window_s)
        self._series: Dict[_SeriesKey, _Series] = {}
        # id(registry) -> (registry, time of its latest sample).
        self._sampled: Dict[int, Tuple[Any, float]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- ingest
    def observe(self, name: str, value: float,
                tags: Optional[Dict[str, str]] = None, *,
                kind: str = "value", ts: Optional[float] = None) -> None:
        """Add one point.  ``kind`` is sticky per series (first wins):
        "counter" marks ``value`` as a cumulative total (rates come from
        deltas), "value" a per-event quantity (rates come from sums),
        "gauge" a level (windows average it)."""
        if kind not in ("counter", "value", "gauge"):
            raise ValueError(f"kind must be counter|value|gauge, got {kind!r}")
        t = time.time() if ts is None else float(ts)
        key = (name, tuple(sorted((tags or {}).items())))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(name, dict(tags or {}),
                                                     kind)
            series.add(t, float(value), t - self.max_window_s)

    def sample_registry(self, registry: Optional[_metrics.MetricsRegistry] = None,
                        ts: Optional[float] = None) -> int:
        """Snapshot every series in the metrics registry into the window;
        returns how many points landed.  Counters and histogram
        ``_sum``/``_count`` components ingest as cumulative "counter"
        series; gauges as "gauge".  A counter series first seen here gets a
        0 point at the registry's previous sample, which would have caught
        it, so its first increments count like those of older series."""
        reg = registry if registry is not None else _metrics.registry()
        t = time.time() if ts is None else float(ts)
        with self._lock:
            prev = self._sampled.get(id(reg))
            if prev is None or t > prev[1]:
                self._sampled[id(reg)] = (reg, t)
        born_after = prev[1] if prev is not None and prev[1] < t else None
        n = 0
        for group in reg.collect():
            lead = group[0]
            # Merge same-name instances exactly like the scrape path does.
            merged: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
            for m in group:
                for suffix, tags, value in m.samples():
                    if suffix == "_bucket":
                        continue  # windows re-derive percentiles themselves
                    k = (suffix, tuple(sorted(tags.items())))
                    if lead._type == "gauge":
                        merged[k] = value
                    else:
                        merged[k] = merged.get(k, 0.0) + value
            kind = "gauge" if lead._type == "gauge" else "counter"
            for (suffix, tag_items), value in merged.items():
                name, tags = lead.name + suffix, dict(tag_items)
                if kind == "counter" and born_after is not None \
                        and self._get(name, tags) is None:
                    # Without this baseline an error counter born in a
                    # burst misses the errors before its first sample while
                    # the request total beside it counts them.
                    self.observe(name, 0.0, tags, kind=kind, ts=born_after)
                self.observe(name, value, tags, kind=kind, ts=t)
                n += 1
        return n

    # ------------------------------------------------------------ queries
    def _get(self, name: str,
             tags: Optional[Dict[str, str]]) -> Optional[_Series]:
        key = (name, tuple(sorted((tags or {}).items())))
        with self._lock:
            return self._series.get(key)

    def _match(self, name: str,
               tags: Optional[Dict[str, str]]) -> List[_Series]:
        """Series answering a ``(name, tags)`` query: the exact tag-set
        when one exists, else every series of that name whose tags are a
        superset of the query (so ``{"pool": "prefill"}`` rolls up the
        per-``(pool, deployment)`` LLM gauges, and no tags at all means
        "all tag-sets" instead of silently missing)."""
        key = (name, tuple(sorted((tags or {}).items())))
        with self._lock:
            exact = self._series.get(key)
            if exact is not None:
                return [exact]
            return [s for (n, _), s in self._series.items()
                    if n == name and _subset(tags, s.tags)]

    def _rate_locked(self, series: _Series, start: float,
                     window_s: float) -> float:
        ts, values = series.window(start)
        if not ts:
            return 0.0
        if series.kind == "counter":
            total = 0.0
            for i in range(1, len(ts)):
                if ts[i] >= start:
                    total += max(0.0, values[i] - values[i - 1])
            return total / float(window_s)
        in_win = [v for t, v in zip(ts, values) if t >= start]
        if not in_win:
            return 0.0
        if series.kind == "gauge":
            return sum(in_win) / len(in_win)
        return sum(in_win) / float(window_s)

    def window_rate(self, name: str, tags: Optional[Dict[str, str]] = None,
                    window_s: float = 60.0,
                    now: Optional[float] = None) -> float:
        """Per-second rate over the trailing window — THE autoscaler query.

        counter: sum of positive deltas between consecutive samples whose
        later point falls in the window, over ``window_s`` (a reset — the
        total dropping — contributes 0, not a negative spike).
        value: sum of in-window points over ``window_s``.
        gauge: the windowed mean (a level has no meaningful rate; the mean
        is what "utilization over the last minute" asks for).

        Queries whose tag-set has no exact series aggregate every series
        carrying a superset of the tags: counters/values sum (total rate),
        gauges average (mean level across tag-sets).
        """
        matches = self._match(name, tags)
        if not matches:
            return 0.0
        t1 = time.time() if now is None else float(now)
        start = t1 - float(window_s)
        with self._lock:
            rates = [self._rate_locked(s, start, window_s) for s in matches]
        if matches[0].kind == "gauge":
            return sum(rates) / len(rates)
        return sum(rates)

    def window_sum(self, name: str, tags: Optional[Dict[str, str]] = None,
                   window_s: float = 60.0,
                   now: Optional[float] = None) -> float:
        """Total over the trailing window: counter → increase, value →
        sum of points, gauge → windowed mean (summing levels is noise).
        Subset-tag queries aggregate like :meth:`window_rate`."""
        matches = self._match(name, tags)
        if not matches:
            return 0.0
        rate = self.window_rate(name, tags, window_s, now)
        return rate if matches[0].kind == "gauge" else rate * float(window_s)

    def window_values(self, name: str,
                      tags: Optional[Dict[str, str]] = None,
                      window_s: float = 60.0,
                      now: Optional[float] = None) -> List[float]:
        """All in-window point values across every matching series (the
        SLO watchdog's bad-fraction input: each point is one request's
        latency, so "fraction over threshold" is exact, not bucketed)."""
        matches = self._match(name, tags)
        t1 = time.time() if now is None else float(now)
        start = t1 - float(window_s)
        out: List[float] = []
        with self._lock:
            for series in matches:
                ts, values = series.window(start)
                out.extend(v for t, v in zip(ts, values) if t >= start)
        return out

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    # --------------------------------------------- cross-process movement
    def snapshot(self, since: Optional[float] = None) -> Dict[str, Any]:
        """Serializable copy of retained points (optionally only those at
        or after ``since``) — what a node ships to the head collector."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for series in self._series.values():
                i = (bisect.bisect_left(series.ts, float(since))
                     if since is not None else 0)
                if i >= len(series.ts):
                    continue
                out.append({"name": series.name, "tags": dict(series.tags),
                            "kind": series.kind,
                            "points": list(zip(series.ts[i:],
                                               series.values[i:]))})
        return {"series": out}

    def merge_snapshot(self, snap: Dict[str, Any],
                       extra_tags: Optional[Dict[str, str]] = None) -> int:
        """Fold another aggregator's snapshot in; ``extra_tags`` (e.g.
        ``{"node": <id>}``) keep per-source series distinct so counter
        deltas never mix totals from different processes."""
        n = 0
        for series in snap.get("series", ()):
            tags = dict(series.get("tags") or {})
            if extra_tags:
                tags.update(extra_tags)
            for ts, value in series.get("points", ()):
                self.observe(series["name"], value, tags,
                             kind=series.get("kind", "value"), ts=ts)
                n += 1
        return n

    def openmetrics_text(self, windows: Sequence[float] = (60.0,),
                         now: Optional[float] = None) -> str:
        """OpenMetrics exposition of the window state: for every series,
        its last sample (``<name>_last``) and per-window rollups
        (``<name>_roll{window_s="..."}`` — rate for counters/values, mean
        for gauges).  Ends with ``# EOF`` per the OpenMetrics spec."""
        with self._lock:
            keys = sorted(self._series)
        lines: List[str] = []
        seen_help = set()
        for name, tag_items in keys:
            series = self._get(name, dict(tag_items))
            if series is None or not series.values:
                continue
            if name not in seen_help:
                seen_help.add(name)
                lines.append(f"# TYPE {name}_last gauge")
                lines.append(f"# TYPE {name}_roll gauge")
            body = ",".join(f'{k}="{_metrics._escape(v)}"'
                            for k, v in tag_items)
            base = f"{name}_last{{{body}}}" if body else f"{name}_last"
            lines.append(f"{base} {_metrics._fmt(series.values[-1])}")
            for w in windows:
                rate = self.window_rate(name, dict(tag_items), w, now)
                wbody = body + ("," if body else "") + f'window_s="{w:g}"'
                lines.append(f"{name}_roll{{{wbody}}} {_metrics._fmt(rate)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


class TimeSeriesCollector:
    """Head-side collector: nodes push snapshots, queries see the cluster.

    A plain class so tests can drive it in-process; wrap it in an actor
    with :func:`start_collector` for the cluster deployment.  Per-source
    series stay distinct via a ``node`` tag; ``window_rate`` without tags
    sums the per-node rates (counter/value kinds) so "cluster request
    rate" is one call.
    """

    def __init__(self, max_window_s: float = DEFAULT_MAX_WINDOW_S):
        self._agg = TimeSeriesAggregator(max_window_s)

    def push(self, snapshot: Dict[str, Any], source: str = "") -> int:
        extra = {"node": str(source)} if source else None
        return self._agg.merge_snapshot(snapshot, extra_tags=extra)

    def window_rate(self, name: str, tags: Optional[Dict[str, str]] = None,
                    window_s: float = 60.0,
                    now: Optional[float] = None) -> float:
        # Cluster view (no/partial tags, e.g. missing ``node``) falls out
        # of the aggregator's own subset rollup: per-source series sum
        # (counter/value kinds) or average (gauges).
        return self._agg.window_rate(name, tags, window_s, now)

    def openmetrics_text(self, windows: Sequence[float] = (60.0,),
                         now: Optional[float] = None) -> str:
        return self._agg.openmetrics_text(windows, now)

    def series_names(self) -> List[str]:
        return self._agg.series_names()


def _subset(want: Optional[Dict[str, str]], have: Dict[str, str]) -> bool:
    return all(have.get(k) == v for k, v in (want or {}).items())


COLLECTOR_NAME = "TIMESERIES_COLLECTOR"


def start_collector(max_window_s: float = DEFAULT_MAX_WINDOW_S):
    """Get-or-create the named head-side collector actor."""
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(COLLECTOR_NAME)
    except ValueError:
        pass
    return ray_tpu_torch.remote(TimeSeriesCollector).options(
        name=COLLECTOR_NAME).remote(max_window_s)


_aggregator: Optional[TimeSeriesAggregator] = None
_aggregator_lock = threading.Lock()


def get_aggregator() -> TimeSeriesAggregator:
    """The process-wide aggregator (what ``/timeseries`` samples into)."""
    global _aggregator
    with _aggregator_lock:
        if _aggregator is None:
            _aggregator = TimeSeriesAggregator()
        return _aggregator
