"""Device telemetry plane: compile tracking, device-memory pools, transfer
ledger (the counterpart of ``ray_tpu/util/device_telemetry.py``).

The reference watches the XLA/device layer that the host-side planes
(tracing, the train profiler, the flight recorder) cannot see. The port has
no XLA compile; two events take its place in the same registry:

* **Compile tracking** — :func:`record_compile` keeps a per-process
  registry of every compile with a label, an abstract signature, its wall
  time and a classified trigger (first_compile / shape_change /
  sharding_change / donation_change / recompile). Two taps feed it:
  ``_private/kernel_build.py`` records each ``nvcc`` run of a hand-written
  kernel (label ``kernel:<name>``, the build digest as the signature), and
  ``_private/torch_compat.py``'s ``instrumented_step`` records the first
  call of a step function at each abstract signature (the call that builds
  kernels, picks cuBLAS algorithms and grows the allocator). Rolled up
  through the :class:`~ray_tpu_torch.util.metrics_agent.TimeSeriesCollector`
  via :func:`publish`. A **recompile-storm detector** (recompiles per window
  over a threshold) emits an ``xla.compile_storm`` ERROR span and a
  flight-recorder dump; :func:`storm_tick` is also driven from
  ``HangWatchdog.tick``.
* **Device-memory pools** — named live-byte pools (``kv_blocks``,
  ``mux_weights``, ``ckpt_staging``, ``dag_channel``) tracked host-side via
  :func:`pool_add`/:func:`pool_sub` with high-water marks, plus each CUDA
  device's allocator figures (:func:`device_memory_snapshot`, from
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``; on a host
  without CUDA there are none, as the reference reports none for its CPU
  backend).
* **Transfer ledger** — every h2d/d2h path calls :func:`record_transfer`
  with direction, bytes and source; windowed bandwidth comes from
  :func:`transfer_bw` (also ``ray_tpu_torch.serve.device.transfer_bw``), and
  timed transfers land in the Perfetto "device" lane as ``device.transfer``
  spans.

Metric names are the reference's. Hot-path entry points are a few dict ops
and a counter increment; spans are built only when tracing is on. Hook
sites reach this module through ``sys.modules.get`` probes, so no data,
serve or checkpoint layer gains an import of it, and it imports no torch
at load time.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.util import flight_recorder, metrics, tracing
from ray_tpu_torch.util.metrics_agent import get_aggregator

#: Compile-record tail retained per process (the full history is in the
#: counters; the tail is what snapshots and bundles embed).
_COMPILE_TAIL = 512
#: Transfer-record tail retained per process.
_TRANSFER_TAIL = 256

#: Recompiles (non-first compiles) inside the window that trip the storm
#: detector. Env-overridable so chaos tests can trip it deterministically.
DEFAULT_STORM_THRESHOLD = 8
DEFAULT_STORM_WINDOW_S = 60.0

#: Canonical trigger classifications, in precedence order.
TRIGGER_FIRST = "first_compile"
TRIGGER_SHAPE = "shape_change"
TRIGGER_SHARDING = "sharding_change"
TRIGGER_DONATION = "donation_change"
#: Same signature compiled again (a cleared cache, a duplicated wrapper).
TRIGGER_RECOMPILE = "recompile"

COMPILES_TOTAL = metrics.Counter(
    "ray_tpu_xla_compiles_total",
    "Compile events recorded by the compile taps (kernel builds, a step's "
    "first call at a signature), by label and classified trigger.",
    ("label", "trigger"))
COMPILE_SECONDS = metrics.Counter(
    "ray_tpu_xla_compile_seconds_total",
    "Wall seconds spent compiling, by label — summed across workers via "
    "the collector, duplicated signatures show up as duplicated "
    "compile-seconds.",
    ("label",))
COMPILE_STORMS = metrics.Counter(
    "ray_tpu_xla_compile_storms_total",
    "Recompile storms detected (recompiles/window over threshold).")
POOL_BYTES = metrics.Gauge(
    "ray_tpu_device_pool_bytes",
    "Live bytes attributed to a named device-memory pool (kv_blocks, "
    "mux_weights, ckpt_staging, dag_channel).",
    ("pool",))
POOL_PEAK_BYTES = metrics.Gauge(
    "ray_tpu_device_pool_peak_bytes",
    "High-water mark of a named device-memory pool since process start "
    "(or the last reset).",
    ("pool",))
HBM_BYTES = metrics.Gauge(
    "ray_tpu_device_hbm_bytes",
    "Bytes the CUDA caching allocator has allocated per device "
    "(allocated_bytes.all.current; absent without CUDA).",
    ("device",))
HBM_PEAK_BYTES = metrics.Gauge(
    "ray_tpu_device_hbm_peak_bytes",
    "Peak bytes the CUDA caching allocator has allocated per device "
    "(allocated_bytes.all.peak).",
    ("device",))
TRANSFER_BYTES = metrics.Counter(
    "ray_tpu_device_transfer_bytes_total",
    "Bytes crossing the host<->device boundary, by direction (h2d/d2h) "
    "and source path (ingest_prefetch, ckpt_snapshot, ...).",
    ("direction", "src"))
TRANSFERS_TOTAL = metrics.Counter(
    "ray_tpu_device_transfers_total",
    "Host<->device transfer events, by direction and source path.",
    ("direction", "src"))

_lock = threading.Lock()
#: label -> last-seen signature components, for trigger classification.
_last_sig: Dict[str, Dict[str, Any]] = {}  # guarded_by: _lock
#: Bounded tail of compile records (dicts, JSON-serializable).
_compile_tail: "deque" = deque(maxlen=_COMPILE_TAIL)  # guarded_by: _lock
#: Timestamps of recent non-first compiles, for the storm window.
_recompile_ts: "deque" = deque(maxlen=4096)  # guarded_by: _lock
_storms = 0  # guarded_by: _lock
#: pool -> [live_bytes, peak_bytes]
_pools: Dict[str, List[float]] = {}  # guarded_by: _lock
#: Bounded tail of transfer records.
_transfer_tail: "deque" = deque(maxlen=_TRANSFER_TAIL)  # guarded_by: _lock


# ------------------------------------------------------------------ compiles

def classify_trigger(label: str, shapes: Any, shardings: Any,
                     donation: Any) -> str:
    """What changed vs. the last compile of ``label`` (read-only peek —
    :func:`record_compile` is what updates the last-seen signature)."""
    with _lock:
        prev = _last_sig.get(label)
    return _classify(prev, shapes, shardings, donation)


def _classify(prev: Optional[Dict[str, Any]], shapes: Any, shardings: Any,
              donation: Any) -> str:
    """Pure classification against one previous-signature row (callers
    read ``_last_sig`` under the lock themselves)."""
    if prev is None:
        return TRIGGER_FIRST
    if shapes != prev["shapes"]:
        return TRIGGER_SHAPE
    if shardings != prev["shardings"]:
        return TRIGGER_SHARDING
    if donation != prev["donation"]:
        return TRIGGER_DONATION
    return TRIGGER_RECOMPILE


def record_compile(label: str, *, shapes: Any, shardings: Any = None,
                   donation: Any = (), trace_s: float = 0.0,
                   compile_s: float = 0.0,
                   ts: Optional[float] = None) -> str:
    """Record one compile event; returns the classified trigger.
    ``shapes``/``shardings``/``donation`` are opaque hashable signature
    components — classification only compares them against the label's
    previous compile."""
    t = time.time() if ts is None else ts
    with _lock:
        trigger = _classify(_last_sig.get(label), shapes, shardings,
                            donation)
        _last_sig[label] = {"shapes": shapes, "shardings": shardings,
                            "donation": donation}
        _compile_tail.append({
            "label": label, "trigger": trigger, "ts": t,
            "trace_s": round(float(trace_s), 6),
            "compile_s": round(float(compile_s), 6),
            "signature": repr(shapes)[:200],
        })
        if trigger != TRIGGER_FIRST:
            _recompile_ts.append(t)
    COMPILES_TOTAL.inc(tags={"label": label, "trigger": trigger})
    COMPILE_SECONDS.inc(trace_s + compile_s, tags={"label": label})
    wall = trace_s + compile_s
    tracing.record_span("xla.compile", t - wall, t,
                        attributes={"label": label, "trigger": trigger,
                                    "trace_s": trace_s,
                                    "compile_s": compile_s})
    if trigger != TRIGGER_FIRST:
        storm_tick(now=t)
    return trigger


def compile_records(label: Optional[str] = None) -> List[dict]:
    """Retained compile-record tail (optionally one label's), oldest
    first."""
    with _lock:
        rows = list(_compile_tail)
    if label is not None:
        rows = [r for r in rows if r["label"] == label]
    return rows


def compile_totals() -> Dict[str, Any]:
    """{"compiles", "compile_seconds", "by_trigger", "storms"} summed over
    the retained tail (the counters hold lifetime totals)."""
    with _lock:
        rows = list(_compile_tail)
        storms = _storms
    by_trigger: Dict[str, int] = {}
    for r in rows:
        by_trigger[r["trigger"]] = by_trigger.get(r["trigger"], 0) + 1
    return {"compiles": len(rows),
            "compile_seconds": round(
                sum(r["trace_s"] + r["compile_s"] for r in rows), 6),
            "by_trigger": by_trigger,
            "storms": storms}


def storm_tick(now: Optional[float] = None) -> bool:
    """One storm-detection pass (called inline after every recompile and
    from ``HangWatchdog.tick`` via a module probe): True when recompiles
    inside the window crossed the threshold. Firing drains the window so
    the detector re-arms only after a fresh burst — a sustained storm
    reports once per threshold-worth of recompiles, not per tick."""
    t = time.time() if now is None else now
    threshold = int(os.environ.get("RAY_TPU_COMPILE_STORM_THRESHOLD",
                                   DEFAULT_STORM_THRESHOLD))
    window_s = float(os.environ.get("RAY_TPU_COMPILE_STORM_WINDOW_S",
                                    DEFAULT_STORM_WINDOW_S))
    with _lock:
        while _recompile_ts and _recompile_ts[0] < t - window_s:
            _recompile_ts.popleft()
        if threshold <= 0 or len(_recompile_ts) < threshold:
            return False
        since = _recompile_ts[0]
        count = len(_recompile_ts)
        _recompile_ts.clear()
        global _storms
        _storms += 1
    _report_storm(since, t, count, threshold, window_s)
    return True


def _report_storm(since: float, detected: float, count: int,
                  threshold: int, window_s: float) -> None:
    """Same seam pattern as the watchdog's stall report: metrics, a ring
    event, a retroactive ERROR span and a postmortem dump, all best-effort
    — forensics must never worsen the storm being recorded."""
    COMPILE_STORMS.inc()
    detail = {"recompiles": count, "threshold": threshold,
              "window_s": window_s, "since": since}
    rec = flight_recorder.get_recorder()
    if rec is not None:
        try:
            rec.record_event("xla.compile_storm", detail, now=detected,
                             kind="storm", status="ERROR")
        except Exception:
            pass
    tracing.record_span("xla.compile_storm", since, detected,
                        attributes=detail, status="ERROR: CompileStorm")
    flight_recorder.trigger_dump("compile_storm", detail)


# --------------------------------------------------------------------- pools

def pool_add(pool: str, nbytes: float) -> None:
    """Attribute ``nbytes`` more live bytes to a named pool."""
    _pool_delta(pool, float(nbytes))


def pool_sub(pool: str, nbytes: float) -> None:
    """Release ``nbytes`` from a named pool (floored at zero — release
    paths may run on state an earlier failure already partially freed)."""
    _pool_delta(pool, -float(nbytes))


def _pool_delta(pool: str, delta: float) -> None:
    with _lock:
        row = _pools.get(pool)
        if row is None:
            row = _pools[pool] = [0.0, 0.0]
        row[0] = max(0.0, row[0] + delta)
        row[1] = max(row[1], row[0])
        cur, peak = row
    POOL_BYTES.set(cur, tags={"pool": pool})
    POOL_PEAK_BYTES.set(peak, tags={"pool": pool})


def pool_set(pool: str, nbytes: float) -> None:
    """Set a pool's live bytes absolutely (rebuild-from-scratch callers)."""
    with _lock:
        row = _pools.get(pool)
        if row is None:
            row = _pools[pool] = [0.0, 0.0]
        row[0] = max(0.0, float(nbytes))
        row[1] = max(row[1], row[0])
        cur, peak = row
    POOL_BYTES.set(cur, tags={"pool": pool})
    POOL_PEAK_BYTES.set(peak, tags={"pool": pool})


def pool_bytes() -> Dict[str, Dict[str, float]]:
    """{pool: {"bytes": live, "peak": high-water}} for every tracked pool."""
    with _lock:
        return {p: {"bytes": row[0], "peak": row[1]}
                for p, row in _pools.items()}


def device_memory_snapshot() -> List[Dict[str, Any]]:
    """One row per visible CUDA device, the reference's fields from
    ``torch.cuda.memory_stats`` and ``mem_get_info``: ``bytes_in_use`` is
    ``allocated_bytes.all.current``, ``peak_bytes_in_use``
    ``allocated_bytes.all.peak``, ``bytes_limit`` the device's total
    memory. Without CUDA, no rows (the reference's CPU backend reports
    none). Updates the HBM gauges."""
    rows: List[Dict[str, Any]] = []
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        return rows
    for d in range(count):
        try:
            stats = torch.cuda.memory_stats(d)
            _free, total = torch.cuda.mem_get_info(d)
        except Exception:
            continue
        dev = str(d)
        in_use = float(stats.get("allocated_bytes.all.current", 0.0))
        peak = float(stats.get("allocated_bytes.all.peak", in_use))
        rows.append({"device": dev, "platform": "gpu",
                     "bytes_in_use": in_use, "peak_bytes_in_use": peak,
                     "bytes_limit": float(total)})
        HBM_BYTES.set(in_use, tags={"device": dev})
        HBM_PEAK_BYTES.set(peak, tags={"device": dev})
    return rows


def tree_nbytes(tree: Any) -> int:
    """Payload bytes of a nested list/tuple/dict of array leaves: a torch
    tensor counts ``element_size() * numel()``, anything else with an
    ``nbytes`` (numpy) that; leaves with neither count 0."""
    total = 0
    stack = [tree]
    while stack:
        obj = stack.pop()
        numel = getattr(obj, "numel", None)
        element_size = getattr(obj, "element_size", None)
        if callable(numel) and callable(element_size):
            total += int(element_size()) * int(numel())
            continue
        nbytes = getattr(obj, "nbytes", None)
        if nbytes is not None:
            try:
                total += int(nbytes)
            except Exception:
                pass
            continue
        if isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
    return total


# ------------------------------------------------------------------ transfers

def record_transfer(direction: str, nbytes: float, *, src: str = "",
                    start: Optional[float] = None,
                    end: Optional[float] = None) -> None:
    """Ledger one host<->device transfer (``direction`` is "h2d"/"d2h").
    When ``start``/``end`` are given the transfer also lands in the
    Perfetto device lane as a ``device.transfer`` span."""
    t = time.time() if end is None else end
    tags = {"direction": direction, "src": src}
    TRANSFER_BYTES.inc(max(0.0, float(nbytes)), tags=tags)
    TRANSFERS_TOTAL.inc(tags=tags)
    with _lock:
        _transfer_tail.append({"ts": t, "direction": direction, "src": src,
                               "bytes": int(nbytes)})
    if start is not None and tracing.is_tracing_enabled():
        tracing.record_span("device.transfer", start, t,
                            attributes={"direction": direction, "src": src,
                                        "bytes": int(nbytes)})


def transfer_records() -> List[dict]:
    """Retained transfer-ledger tail, oldest first."""
    with _lock:
        return list(_transfer_tail)


def transfer_bw(direction: Optional[str] = None, *, src: Optional[str] = None,
                window_s: float = 60.0,
                now: Optional[float] = None) -> float:
    """Windowed host<->device bandwidth (bytes/s) over the trailing
    window, optionally filtered by direction and/or source path — the
    same sample-then-query aggregator idiom as the serve accessors."""
    agg = get_aggregator()
    agg.sample_registry(ts=now)
    tags: Dict[str, str] = {}
    if direction is not None:
        tags["direction"] = direction
    if src is not None:
        tags["src"] = src
    return agg.window_rate("ray_tpu_device_transfer_bytes_total",
                           tags or None, window_s, now)


# ---------------------------------------------------------------------- burns

def record_burn(label: str, start: float, end: float,
                attributes: Optional[Dict[str, Any]] = None) -> None:
    """Timeline a device compute burn (one step, a decode burn) into the
    Perfetto device lane. Pure span sugar — a no-op when tracing is off."""
    if not tracing.is_tracing_enabled():
        return
    attrs = dict(attributes or {})
    attrs["label"] = label
    tracing.record_span("device.burn", start, end, attributes=attrs)


# ------------------------------------------------------------------- snapshot

def snapshot(*, transfer_window_s: float = 60.0,
             now: Optional[float] = None) -> Dict[str, Any]:
    """JSON-serializable device-telemetry snapshot: compile registry tail
    and totals, pool high-water, transfer window and tail, device memory.
    What forensics bundles embed and ``serve.status()`` / the train run
    registry surface. Consults the ``device_telemetry_snapshot`` fault
    point, so chaos proves every embedding site absorbs a telemetry
    failure."""
    fault_injection.check("device_telemetry_snapshot")
    t = time.time() if now is None else now
    totals = compile_totals()
    return {
        "ts": t,
        "compiles": {
            "totals": totals,
            "tail": compile_records()[-50:],
        },
        "pools": pool_bytes(),
        "transfers": {
            "tail": transfer_records()[-50:],
            "window_s": transfer_window_s,
            "bytes_per_s": {
                "h2d": transfer_bw("h2d", window_s=transfer_window_s,
                                   now=now),
                "d2h": transfer_bw("d2h", window_s=transfer_window_s,
                                   now=now),
            },
        },
        "device_memory": device_memory_snapshot(),
    }


def publish(collector: Any, source: str = "", *,
            since: Optional[float] = None,
            now: Optional[float] = None) -> Any:
    """Roll this process's metric window up to a
    :class:`~ray_tpu_torch.util.metrics_agent.TimeSeriesCollector` (plain
    instance or named actor handle): sample the registry, snapshot the
    aggregator, push tagged with ``source`` so per-worker compile-seconds
    stay distinct series that cluster queries sum."""
    agg = get_aggregator()
    agg.sample_registry(ts=now)
    snap = agg.snapshot(since=since)
    push = collector.push
    if hasattr(push, "remote"):  # actor handle
        return push.remote(snap, source)
    return push(snap, source)


def reset() -> None:
    """Drop all retained state (tests, bench arms): compile registry, storm
    window, pools (gauges cleared), transfer tail."""
    with _lock:
        _last_sig.clear()
        _compile_tail.clear()
        _recompile_ts.clear()
        _transfer_tail.clear()
        _pools.clear()
        global _storms
        _storms = 0
    POOL_BYTES.clear()
    POOL_PEAK_BYTES.clear()
    HBM_BYTES.clear()
    HBM_PEAK_BYTES.clear()
