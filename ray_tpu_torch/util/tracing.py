"""Distributed tracing: spans around task submit/execute (the counterpart of
``ray_tpu/util/tracing.py``).

Counterpart of the reference's OpenTelemetry integration
(ref: util/tracing/tracing_helper.py — _OpenTelemetryProxy:34,
_is_tracing_enabled:92): opt-in via `enable_tracing()`; when on, every task
submission opens a submit span and every execution opens an execute span
parented on the submitter's span — the trace context rides inside the
TaskSpec exactly like the reference propagates it in its TaskSpec proto.
Spans go to a pluggable exporter (default: in-memory buffer; any callable
taking a span dict works, e.g. one that forwards to an OTLP client).
"""

from __future__ import annotations

import contextvars
import itertools
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from collections import deque

_enabled = False
_exporter: Optional[Callable[[dict], None]] = None
#: Default exporter: bounded ring buffer (2 spans/task would otherwise grow
#: without limit in a long-running driver).
_BUFFER_MAX = 100_000
_buffer: "deque" = deque(maxlen=_BUFFER_MAX)
_buffer_lock = threading.Lock()
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_span", default=None)

# Span/trace id generation sits on the serve hot path (several spans per
# request, mostly on the proxy/replica event loops), so uuid4's ~2us of
# os.urandom per id is real QPS: ids here are a random per-process base
# XOR a golden-ratio-mixed atomic counter — ~0.1us, unique within the
# process (odd-constant multiply is a bijection mod 2**64) and across
# processes by the base; the mix spreads the counter into the high bits so
# id prefixes (e.g. the per-trace timeline lanes keyed on trace_id[:8])
# still differ.  Tracing ids need uniqueness, not unpredictability.
_ID_BASE = random.SystemRandom().getrandbits(64)
_id_counter = itertools.count(1)  # next() is atomic under the GIL
_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


#: Span names the port opens: name -> what the span covers. Entries ending
#: in ``::`` or ``_`` are prefixes for dynamic names (``f"task::{name}"``,
#: ``f"serve.ttft_{bucket}"``).
SPAN_REGISTRY: Dict[str, str] = {
    "submit::": "driver-side task submission (suffix: task name)",
    "task::": "worker-side task execution (suffix: task name)",
    "serve.http_request": "proxy: full HTTP request lifetime",
    "serve.route": "router: replica pick + dispatch",
    "serve.replica": "replica: user-handler execution",
    "serve.queue_wait": "batching: enqueue -> batch formation, per request",
    "serve.batch_execute": "batching: vectorized user call, per request",
    "serve.stream_emit": "proxy: one streamed response, first chunk -> end",
    "serve.ttft_": "llm: one TTFT attribution bucket (suffix: queue | "
                   "admission | prefill | handoff | residual)",
    "serve.preempt_recompute": "llm: prefill re-run of already-generated "
                               "tokens after a preemption",
    "serve.slo_burn": "slo: one deployment's burn episode, alert -> clear",
    "forensics.dump": "flight recorder: one postmortem dump, trigger -> "
                      "file written",
    "data.ingest": "ingest: one source shard, first pull -> last block out",
    "data.locality_claim": "ingest: one locality-aware shard claim "
                           "(attrs: preferred, local)",
    "data.prefetch": "ingest: host->device transfer dispatch, per batch",
    "train.step": "profiler: one training step, report() to report()",
    "train.elastic": "controller: elastic recovery, failure -> resumed",
    "train.data_wait": "profiler: step blocked on the input pipeline",
    "train.h2d": "profiler: host->device batch transfer within a step",
    "train.compute": "profiler: step compute residual (wall - waits)",
    "train.collective": "profiler: gradient-sync rendezvous within a step",
    "train.ckpt_block": "profiler: device->host snapshot blocking a step",
    "train.stall": "watchdog: detected progress stall, last progress -> "
                   "detection (status ERROR)",
    "checkpoint.save": "writer: device->host snapshot, shard serialize + "
                       "persist",
    "checkpoint.commit": "coordinator: commit phase up to atomic rename",
    "checkpoint.restore": "restore_pytree entry",
    "xla.compile": "device telemetry: one compile through a compile tap (a "
                   "kernel's nvcc run, a step's first call at a signature)",
    "xla.compile_storm": "device telemetry: recompile storm episode, first "
                         "recompile in window -> detection (status ERROR)",
    "device.transfer": "device telemetry: one timed host<->device "
                       "transfer (attrs: direction, src, bytes)",
    "device.burn": "device telemetry: one device compute burn (a step "
                   "execution, a decode burn)",
}


def _new_id64() -> str:
    return f"{_ID_BASE ^ (next(_id_counter) * _GOLDEN & _MASK64):016x}"


def _new_trace_id() -> str:
    return _new_id64() + f"{_ID_BASE:016x}"


def is_tracing_enabled() -> bool:
    """(ref: tracing_helper.py:92)."""
    return _enabled


def enable_tracing(exporter: Optional[Callable[[dict], None]] = None) -> None:
    global _enabled, _exporter
    _enabled = True
    _exporter = exporter


def disable_tracing() -> None:
    global _enabled, _exporter
    _enabled = False
    _exporter = None


def exported_spans() -> List[dict]:
    """Spans captured by the default in-memory exporter."""
    # deque.append is atomic, so the hot path exports lock-free; snapshots
    # just retry the rare "mutated during iteration" race.
    for _ in range(100):
        try:
            return list(_buffer)
        except RuntimeError:
            continue
    return list(_buffer)


def clear_spans() -> None:
    with _buffer_lock:
        _buffer.clear()


#: Passive span tap (flight recorder): sees every span the exporter sees,
#: including ones that outlive their tracing session — the recorder is a
#: black box, not a tracing consumer.  One global load + None check on the
#: hot path when no tap is installed.
_tap: Optional[Callable[[dict], None]] = None


def set_span_tap(fn: Optional[Callable[[dict], None]]) -> None:
    """Install (or clear with None) the passive span tap.  The tap must be
    cheap and must never raise — it runs inline on every span export."""
    global _tap
    _tap = fn


def _export(span: dict) -> None:
    if _tap is not None:
        _tap(span)
    if not _enabled:
        return  # span outlived its tracing session (e.g. a parked long-poll)
    if _exporter is not None:
        _exporter(span)
    else:
        _buffer.append(span)


def current_context() -> Optional[dict]:
    """{"trace_id", "span_id"} of the active span, for propagation."""
    span = _current_span.get()
    if span is None:
        return None
    return {"trace_id": span["trace_id"], "span_id": span["span_id"]}


def active_span() -> Optional[dict]:
    """The active span dict itself (or None) — zero-allocation alternative
    to current_context() for in-process consumers (histogram exemplars,
    batch-span parents).  Treat it as read-only; its trace_id/span_id stay
    valid after the span closes, but cross-process propagation must use
    current_context() (the span dict carries arbitrary attribute objects)."""
    return _current_span.get()


class _NullSpan:
    """Context manager returned when tracing is off — zero per-use cost."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Class-based span context manager: ~2x cheaper to enter/exit than a
    generator @contextmanager, which matters at several spans per request."""

    __slots__ = ("_s", "_token")

    def __init__(self, s: dict):
        self._s = s

    def __enter__(self):
        self._token = _current_span.set(self._s)
        return self._s

    def __exit__(self, et, ev, tb):
        s = self._s
        if et is not None:
            s["status"] = f"ERROR: {et.__name__}"
        s["end"] = _now()
        _current_span.reset(self._token)
        _export(s)
        return False


_now = time.time


def span(name: str, parent: Optional[dict] = None,
         attributes: Optional[Dict[str, Any]] = None):
    """Open a span; nests under the active span unless `parent` is given.

    The span takes ownership of `attributes` — callers must not mutate the
    dict afterwards (hot path: no defensive copy)."""
    if not _enabled:
        return _NULL_SPAN
    if parent is None:
        # The active span dict itself carries trace_id/span_id — no need to
        # build the {"trace_id", "span_id"} projection on the hot path.
        parent = _current_span.get()
    if parent is not None:
        trace_id = parent.get("trace_id") or _new_trace_id()
        parent_id = parent.get("span_id")
    else:
        trace_id = _new_trace_id()
        parent_id = None
    s = {
        "name": name,
        "trace_id": trace_id,
        "span_id": _new_id64(),
        "parent_id": parent_id,
        "start": _now(),
        "end": None,
        "attributes": attributes if attributes is not None else {},
        "status": "OK",
    }
    return _SpanCtx(s)


def record_span(name: str, start: float, end: float, *,
                trace_id: Optional[str] = None,
                parent: Optional[dict] = None,
                attributes: Optional[Dict[str, Any]] = None,
                status: str = "OK") -> Optional[dict]:
    """Export a retroactively-timed span (e.g. queue wait measured after the
    fact from an enqueue timestamp). Returns the span dict, or None when
    tracing is off.

    Takes ownership of `attributes` (no defensive copy); passing one shared
    dict for a whole batch of spans is fine as long as nobody mutates it."""
    if not _enabled:
        return None
    if parent is None:
        parent = _current_span.get()
    if parent is not None:
        tid = trace_id or parent.get("trace_id") or _new_trace_id()
        parent_id = parent.get("span_id")
    else:
        tid = trace_id or _new_trace_id()
        parent_id = None
    s = {
        "name": name,
        "trace_id": tid,
        "span_id": _new_id64(),
        "parent_id": parent_id,
        "start": start,
        "end": end,
        "attributes": attributes if attributes is not None else {},
        "status": status,
    }
    _export(s)
    return s


def record_span_batch(name: str, intervals, *,
                      attributes: Optional[Dict[str, Any]] = None) -> None:
    """Export one retroactive span per (start, end, parent_ctx) interval in
    a single tight loop — the serve batching layer attributes queue-wait
    and execute spans to every request of a micro-batch this way, keeping
    per-item call overhead off the replica event loop.  Intervals with a
    None parent are skipped (request wasn't traced); all spans share the
    `attributes` dict (callers must not mutate it afterwards)."""
    if not _enabled:
        return
    attrs = attributes if attributes is not None else {}
    emit = _exporter if _exporter is not None else _buffer.append
    tap = _tap
    for start, end, parent in intervals:
        if parent is None:
            continue
        s = {
            "name": name,
            "trace_id": parent.get("trace_id") or _new_trace_id(),
            "span_id": _new_id64(),
            "parent_id": parent.get("span_id"),
            "start": start,
            "end": end,
            "attributes": attrs,
            "status": "OK",
        }
        if tap is not None:
            tap(s)
        emit(s)


def inject_task_spec(spec) -> None:
    """Called at submit time: stamp the submitter's context onto the spec."""
    if _enabled:
        spec.trace_ctx = current_context()


def task_execute_span(spec):
    """Execute-side span parented on the submit-side context in the spec
    (the reference wraps the worker's task execution the same way)."""
    if not _enabled:
        return _NULL_SPAN
    # task_id is a str subclass — store it directly, no str() copy.
    return span(f"task::{spec.name}",
                parent=getattr(spec, "trace_ctx", None),
                attributes={"task_id": spec.task_id,
                            "attempt": spec.attempt})
