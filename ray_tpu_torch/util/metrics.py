"""Application metrics API: Counter / Gauge / Histogram (the counterpart of
``ray_tpu/util/metrics.py``).

Counterpart of the reference's `ray.util.metrics`
(ref: python/ray/util/metrics.py — Counter:137, Histogram:187, Gauge:262):
the same three metric types with tag support, backed by a process-local
registry that renders itself in Prometheus text exposition format
(``registry().prometheus_text()``), which the metrics agent
(``_private/metrics_agent.py``) serves over HTTP.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

TagMap = Dict[str, str]
_key = Tuple[Tuple[str, str], ...]
#: (labels, observed value, unix ts) attached to one histogram bucket —
#: OpenMetrics exemplars (the reference attaches trace-id exemplars to its
#: Prometheus histograms the same way).
Exemplar = Tuple[TagMap, float, float]


def _tag_key(tags: Optional[TagMap]) -> _key:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Base: name, help text, declared tag keys, default tags."""

    _type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name or any(c in name for c in " \n"):
            raise ValueError(f"invalid metric name: {name!r}")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: TagMap = {}
        self._lock = threading.Lock()
        _REGISTRY.register(self)

    @property
    def name(self) -> str:
        return self._name

    @property
    def info(self) -> dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys, "type": self._type,
                "default_tags": dict(self._default_tags)}

    def set_default_tags(self, tags: TagMap) -> "Metric":
        self._check_tags(tags)
        self._default_tags = dict(tags)
        return self

    def _check_tags(self, tags: Optional[TagMap]) -> TagMap:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        for k in merged:
            if k not in self._tag_keys:
                raise ValueError(
                    f"tag {k!r} not in declared tag_keys {self._tag_keys}")
        return merged

    # Subclasses: samples() -> [(suffix, tags, value)]
    def samples(self) -> List[Tuple[str, TagMap, float]]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing count (ref: util/metrics.py:137)."""

    _type = "counter"

    def __init__(self, name, description="", tag_keys=None):
        self._values: Dict[_key, float] = {}
        super().__init__(name, description, tag_keys)

    def inc(self, value: float = 1.0, tags: Optional[TagMap] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc requires value >= 0")
        if value == 0:
            # No-op, not an error: natural zero increments (an empty block,
            # a batch of zero retries) shouldn't force callers to guard or
            # lie with max(1, x).  The series is not created either — a
            # counter that never counted anything has nothing to export.
            return
        merged = self._check_tags(tags)
        k = _tag_key(merged)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def get(self, tags: Optional[TagMap] = None) -> float:
        """Current count for a tag set (0.0 if never incremented) — for
        tests and in-process introspection; scraping goes through samples()."""
        k = _tag_key(self._check_tags(tags))
        with self._lock:
            return self._values.get(k, 0.0)

    def samples(self):
        with self._lock:
            return [("", dict(k), v) for k, v in self._values.items()]


class Gauge(Metric):
    """Point-in-time value (ref: util/metrics.py:262)."""

    _type = "gauge"

    def __init__(self, name, description="", tag_keys=None):
        self._values: Dict[_key, float] = {}
        super().__init__(name, description, tag_keys)

    def set(self, value: float, tags: Optional[TagMap] = None) -> None:
        merged = self._check_tags(tags)
        with self._lock:
            self._values[_tag_key(merged)] = float(value)

    def get(self, tags: Optional[TagMap] = None) -> float:
        """Last set value for a tag set (0.0 if never set) — for tests and
        in-process introspection."""
        k = _tag_key(self._check_tags(tags))
        with self._lock:
            return self._values.get(k, 0.0)

    def clear(self) -> None:
        """Drop all tagged series (for samplers that rebuild state counts —
        without this, a series whose population drops to 0 would report its
        stale last value forever)."""
        with self._lock:
            self._values.clear()

    def samples(self):
        with self._lock:
            return [("", dict(k), v) for k, v in self._values.items()]


DEFAULT_BOUNDARIES = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)


class Histogram(Metric):
    """Bucketed distribution (ref: util/metrics.py:187)."""

    _type = "histogram"

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        bounds = tuple(boundaries if boundaries is not None else DEFAULT_BOUNDARIES)
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])) or not bounds:
            raise ValueError(f"boundaries must be sorted/non-empty: {bounds}")
        self.boundaries = bounds
        self._counts: Dict[_key, List[int]] = {}
        self._sums: Dict[_key, float] = {}
        self._totals: Dict[_key, int] = {}
        #: tag set -> bucket index -> last exemplar landing in that bucket
        self._exemplars: Dict[_key, Dict[int, Exemplar]] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[TagMap] = None,
                exemplar: Optional[TagMap] = None) -> None:
        merged = self._check_tags(tags)
        k = _tag_key(merged)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (len(self.boundaries) + 1))
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1
            if exemplar:
                # Last exemplar per bucket (the Prometheus client keeps one
                # per bucket the same way) — e.g. {"trace_id": ...} linking
                # this observation back to its distributed trace.  Takes
                # ownership of the dict (hot path: no defensive copy).
                self._exemplars.setdefault(k, {})[i] = (
                    exemplar, float(value), time.time())

    def observe_batch(self, values: Sequence[float],
                      tags: Optional[TagMap] = None,
                      exemplar: Optional[TagMap] = None) -> None:
        """Record many observations for ONE tag set under a single lock
        round-trip — the serve batching layer records a whole micro-batch's
        queue waits this way so per-item locking stays off the replica
        event loop.  `exemplar` (if any) is attached to the first value's
        bucket."""
        if not values:
            return
        merged = self._check_tags(tags)
        k = _tag_key(merged)
        bounds = self.boundaries
        nb = len(bounds)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (nb + 1))
            total = 0.0
            for value in values:
                i = 0
                while i < nb and value > bounds[i]:
                    i += 1
                counts[i] += 1
                total += value
            self._sums[k] = self._sums.get(k, 0.0) + total
            self._totals[k] = self._totals.get(k, 0) + len(values)
            if exemplar:
                value = values[0]
                i = 0
                while i < nb and value > bounds[i]:
                    i += 1
                self._exemplars.setdefault(k, {})[i] = (
                    exemplar, float(value), time.time())

    def get(self, tags: Optional[TagMap] = None) -> dict:
        """Snapshot for one tag set: count/sum/per-bucket counts — the
        in-process view tests and the serve rollups read."""
        k = _tag_key(self._check_tags(tags))
        with self._lock:
            counts = list(self._counts.get(k, ()))
            return {
                "boundaries": list(self.boundaries),
                "counts": counts or [0] * (len(self.boundaries) + 1),
                "count": self._totals.get(k, 0),
                "sum": self._sums.get(k, 0.0),
            }

    def percentile(self, q: float, tags: Optional[TagMap] = None) -> float:
        """Estimate the q-th percentile (q in [0, 100]) for a tag set from
        the bucket counts; 0.0 if nothing was observed."""
        snap = self.get(tags)
        return percentile_from_buckets(snap["boundaries"], snap["counts"], q)

    def exemplars(self) -> Dict[Tuple[_key, str], Exemplar]:
        """{(tag set, le label) -> exemplar} for the scrape path."""
        out: Dict[Tuple[_key, str], Exemplar] = {}
        with self._lock:
            for k, per_bucket in self._exemplars.items():
                for i, ex in per_bucket.items():
                    le = ("+Inf" if i >= len(self.boundaries)
                          else repr(float(self.boundaries[i])))
                    out[(k, le)] = ex
        return out

    def samples(self):
        out = []
        with self._lock:
            for k, counts in self._counts.items():
                tags = dict(k)
                cum = 0
                for b, c in zip(self.boundaries, counts):
                    cum += c
                    out.append(("_bucket", {**tags, "le": repr(float(b))}, cum))
                out.append(("_bucket", {**tags, "le": "+Inf"}, self._totals[k]))
                out.append(("_sum", tags, self._sums[k]))
                out.append(("_count", tags, self._totals[k]))
        return out


class MetricsRegistry:
    """Process-local registry; the agent scrapes it.

    Same-name metrics from independent call sites are legal (the reference
    aggregates them through OpenCensus): all instances are kept and their
    samples merged at scrape time — summed for counters/histograms,
    last-writer-wins for gauges — so no instance's data is silently lost.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, List[Metric]] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> None:
        with self._lock:
            group = self._metrics.setdefault(metric.name, [])
            if group and type(group[0]) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered with type "
                    f"{group[0]._type}")
            group.append(metric)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def collect(self) -> List[List[Metric]]:
        with self._lock:
            return [list(g) for g in self._metrics.values()]

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (what /metrics serves).

        Histogram ``_bucket`` lines carry OpenMetrics-style exemplars
        (``# {trace_id="..."} value ts``) when observations recorded them —
        the hook Grafana/Tempo use to jump from a latency bucket straight
        to one exemplifying distributed trace.
        """
        lines: List[str] = []
        for group in self.collect():
            lead = group[0]
            lines.append(f"# HELP {lead.name} {lead._description}")
            lines.append(f"# TYPE {lead.name} {lead._type}")
            merged: Dict[Tuple[str, _key], float] = {}
            for m in group:
                for suffix, tags, value in m.samples():
                    k = (suffix, _tag_key(tags))
                    if lead._type == "gauge":
                        merged[k] = value
                    else:
                        merged[k] = merged.get(k, 0.0) + value
            exemplars: Dict[Tuple[_key, str], Exemplar] = {}
            for m in group:
                if isinstance(m, Histogram):
                    exemplars.update(m.exemplars())
            for (suffix, tag_items), value in merged.items():
                if tag_items:
                    body = ",".join(
                        f'{k}="{_escape(v)}"' for k, v in tag_items)
                    line = f"{lead.name}{suffix}{{{body}}} {_fmt(value)}"
                else:
                    line = f"{lead.name}{suffix} {_fmt(value)}"
                if suffix == "_bucket":
                    tags = dict(tag_items)
                    le = tags.pop("le", None)
                    ex = exemplars.get((_tag_key(tags), le))
                    if ex is not None:
                        ex_labels, ex_value, ex_ts = ex
                        ex_body = ",".join(
                            f'{k}="{_escape(v)}"'
                            for k, v in sorted(ex_labels.items()))
                        line += (f" # {{{ex_body}}} {_fmt(ex_value)}"
                                 f" {ex_ts:.3f}")
                lines.append(line)
        return "\n".join(lines) + "\n"


def percentile_from_buckets(boundaries: Sequence[float],
                            counts: Sequence[int], q: float) -> float:
    """Estimate the q-th percentile (q in [0, 100]) from per-bucket counts.

    ``counts`` has one entry per boundary plus the overflow bucket, exactly
    as Histogram records them.  Linear interpolation inside the target
    bucket (the same estimate Prometheus's histogram_quantile makes); the
    overflow bucket clamps to the top boundary — a bucketed histogram
    cannot resolve beyond its largest bound.
    """
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = (q / 100.0) * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(boundaries):  # overflow: clamp to the top bound
                return float(boundaries[-1])
            lo = boundaries[i - 1] if i > 0 else 0.0
            hi = boundaries[i]
            frac = (rank - prev_cum) / c
            return float(lo + (hi - lo) * min(1.0, max(0.0, frac)))
    return float(boundaries[-1])


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY
