"""Always-on flight recorder: a black-box ring of the recent past (the
counterpart of ``ray_tpu/util/flight_recorder.py``).

The tracing and metrics planes observe a process *while it is alive and
someone is asking*; when a replica dies, a trainer wedges, or the SLO
watchdog trips, the spans that explain it are already gone.  The recorder
keeps a bounded, always-on record that survives the event:

* a fixed-size, lock-free per-process ring buffer of recent spans
  (passively tapped from :mod:`ray_tpu_torch.util.tracing`'s exporter via
  ``set_span_tap``), serve state transitions (``record_event``: applied
  autoscale decisions) and coarse metric deltas
  (``sample_metric_deltas``);
* ``dump(reason)``: snapshot the ring plus all-thread stacks (reusing
  :mod:`~ray_tpu_torch._private.stack_profiler`) to
  ``<session>/postmortems/<pid>-<reason>.json`` — triggered by the SLO
  watchdog on a breach and via the explicit API (the reference's other
  trigger sites come with their modules, ROADMAP.md Queue 1).

Cost discipline matches the span export: slots are preallocated
fixed-width lists mutated in place (no per-event allocation), the write
index is an ``itertools.count`` (``next()`` is atomic under the GIL), and
readers detect torn slots with a seqlock stamp — a writer marks the slot
in-progress (negative seq), fills the fields, then publishes the final
seq.  ``snapshot()`` skips in-progress slots and re-checks the stamp
after copying, so concurrent recording never blocks and never yields a
half-written row.  Disable with ``RAY_TPU_FLIGHT_RECORDER=0``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import tracemalloc
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import metrics, tracing

#: Ring capacity (events).  ~120 bytes/slot -> the default is ~1 MB of
#: bounded memory per process; override with RAY_TPU_FLIGHT_RECORDER_SLOTS.
DEFAULT_SLOTS = 8192

#: Per-reason dump flood control: a crash loop must not turn the
#: postmortem dir into a disk leak.  Override (seconds) with
#: RAY_TPU_POSTMORTEM_MIN_INTERVAL_S.
DEFAULT_MIN_DUMP_INTERVAL_S = 5.0

#: Slot layout (fixed width, mutated in place): seq is written twice by
#: the seqlock protocol — negative while the row is being filled, the
#: final positive value when published.
_F_SEQ, _F_KIND, _F_NAME, _F_T0, _F_T1, _F_STATUS, _F_DETAIL = range(7)

DUMPS_TOTAL = metrics.Counter(
    "ray_tpu_forensics_dumps_total",
    "Postmortem dumps written, by trigger reason.", ("reason",))
DUMPS_SUPPRESSED_TOTAL = metrics.Counter(
    "ray_tpu_forensics_dumps_suppressed_total",
    "Postmortem dumps skipped by per-reason flood control.", ("reason",))
DUMP_SECONDS = metrics.Histogram(
    "ray_tpu_forensics_dump_seconds",
    "Wall time of one postmortem dump (ring snapshot + stacks + write).",
    boundaries=[0.001, 0.01, 0.1, 0.5, 2.0])
RING_EVENTS_TOTAL = metrics.Counter(
    "ray_tpu_forensics_ring_events_total",
    "Events recorded into the flight-recorder ring, by kind.", ("kind",))


def postmortem_dir() -> str:
    """``<session>/postmortems``, or ``$RAY_TPU_POSTMORTEM_DIR``."""
    from ray_tpu_torch._private.config import session_subdir

    return session_subdir("postmortems", "RAY_TPU_POSTMORTEM_DIR")


class FlightRecorder:
    """Fixed-size lock-free event ring + postmortem dump writer."""

    def __init__(self, slots: int = DEFAULT_SLOTS):
        self._n = max(16, int(slots))
        # Preallocated fixed-width rows; recording mutates fields in place.
        self._ring: List[list] = [
            [-1, "", "", 0.0, 0.0, "", None] for _ in range(self._n)]
        self._seq = itertools.count()  # next() is atomic under the GIL
        self._last_dump: Dict[str, float] = {}  # guarded_by: _dump_lock
        self._dump_lock = threading.Lock()
        # Metric-delta baseline (sampled from one caller thread only).
        self._metric_base: Dict[str, float] = {}  # owned_by_thread: sample_metric_deltas caller

    # ------------------------------------------------------------ recording
    def _record(self, kind: str, name: str, t0: float, t1: float,
                status: str, detail: Any) -> None:
        seq = next(self._seq)
        slot = self._ring[seq % self._n]
        slot[_F_SEQ] = -seq - 1          # mark in-progress (seqlock)
        slot[_F_KIND] = kind
        slot[_F_NAME] = name
        slot[_F_T0] = t0
        slot[_F_T1] = t1
        slot[_F_STATUS] = status
        slot[_F_DETAIL] = detail
        slot[_F_SEQ] = seq               # publish

    def tap_span(self, span: dict) -> None:
        """Passive tracing tap — called inline on every span export; must
        stay allocation-free beyond the strings the span already owns."""
        self._record("span", span["name"], span["start"],
                     span["end"] if span["end"] is not None else span["start"],
                     span["status"], None)

    def record_event(self, name: str, detail: Any = None,
                     now: Optional[float] = None, *,
                     kind: str = "event", status: str = "OK") -> None:
        """Record a state transition (actor death, elastic shrink, SLO
        alert, stall, ...) into the ring."""
        ts = time.time() if now is None else now
        self._record(kind, name, ts, ts, status, detail)
        RING_EVENTS_TOTAL.inc(tags={"kind": kind})

    def sample_metric_deltas(self, now: Optional[float] = None) -> int:
        """Record coarse deltas of every counter-style metric since the
        last sample (one caller thread, so the baseline dict needs no
        lock).  Returns the number of deltas
        recorded."""
        ts = time.time() if now is None else now
        recorded = 0
        for group in metrics.registry().collect():
            if group[0]._type != "counter":
                continue
            name = group[0].name
            total = sum(v for m in group for _, _, v in m.samples())
            base = self._metric_base.get(name, 0.0)
            if total != base:
                self._metric_base[name] = total
                self._record("metric", name, ts, ts, "OK", total - base)
                recorded += 1
        return recorded

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> List[dict]:
        """Ordered copy of the ring's published events.  Lock-free: torn
        slots (overwritten mid-copy) are detected by the seq stamp and
        skipped — a snapshot racing heavy recording loses a few events at
        the wrap boundary, never yields a half-written row."""
        rows = []
        for idx, slot in enumerate(self._ring):
            seq = slot[_F_SEQ]
            if seq < 0 or seq % self._n != idx:
                continue  # empty or mid-write
            row = list(slot)
            if slot[_F_SEQ] != seq:
                continue  # overwritten while copying
            rows.append(row)
        rows.sort(key=lambda r: r[_F_SEQ])
        return [{"seq": r[_F_SEQ], "kind": r[_F_KIND], "name": r[_F_NAME],
                 "start": r[_F_T0], "end": r[_F_T1], "status": r[_F_STATUS],
                 "detail": r[_F_DETAIL]} for r in rows]

    def events_recorded(self) -> int:
        """Lifetime event count (>= ring capacity means it has wrapped)."""
        # Peek without consuming: count() has no peek, so derive from the
        # newest published slot instead.
        newest = max((s[_F_SEQ] for s in self._ring), default=-1)
        return newest + 1

    # ----------------------------------------------------------------- dump
    def dump(self, reason: str, extra: Optional[dict] = None,
             now: Optional[float] = None) -> Optional[str]:
        """Snapshot ring + all-thread stacks (+ heap, iff tracemalloc was
        already tracing) to ``<session>/postmortems/<pid>-<reason>.json``.

        Returns the file path, or None when flood control suppressed the
        dump.  Raises on write failure (and at the ``forensics_dump``
        chaos point) — trigger sites absorb via :func:`trigger_dump`.
        """
        from ray_tpu_torch._private import fault_injection

        fault_injection.check("forensics_dump")
        ts = time.time() if now is None else now
        with self._dump_lock:
            last = self._last_dump.get(reason)
            min_gap = float(os.environ.get(
                "RAY_TPU_POSTMORTEM_MIN_INTERVAL_S",
                DEFAULT_MIN_DUMP_INTERVAL_S))
            if last is not None and ts - last < min_gap:
                DUMPS_SUPPRESSED_TOTAL.inc(tags={"reason": reason})
                return None
            self._last_dump[reason] = ts
        from ray_tpu_torch._private import heap_profiler, stack_profiler

        t0 = time.time()
        tracing_active = tracemalloc.is_tracing()
        payload: Dict[str, Any] = {
            "schema": 1,
            "pid": os.getpid(),
            "reason": reason,
            "ts": ts,
            "hostname": os.uname().nodename,
            "ring": self.snapshot(),
            "events_recorded": self.events_recorded(),
            "stacks": stack_profiler.current_process_stacks(),
            # A tracemalloc snapshot only when a real window was open —
            # an empty-window snapshot is the trap the heap profiler's
            # docstring warns about.
            "tracing_active": tracing_active,
        }
        if tracing_active:
            payload["heap"] = heap_profiler.heap_summary()
        if extra:
            payload["extra"] = extra
        d = postmortem_dir()
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in reason)
        path = os.path.join(d, f"{os.getpid()}-{safe}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        t1 = time.time()
        DUMPS_TOTAL.inc(tags={"reason": reason})
        DUMP_SECONDS.observe(t1 - t0)
        tracing.record_span("forensics.dump", t0, t1,
                            attributes={"reason": reason, "path": path})
        return path


# ------------------------------------------------------------------ singleton
_recorder: Optional[FlightRecorder] = None  # guarded_by: _recorder_lock
_recorder_lock = threading.Lock()


def enabled() -> bool:
    return os.environ.get("RAY_TPU_FLIGHT_RECORDER", "1") != "0"


def get_recorder() -> Optional[FlightRecorder]:
    """The process-wide recorder (installs the tracing tap on first use);
    None when disabled via RAY_TPU_FLIGHT_RECORDER=0."""
    global _recorder
    with _recorder_lock:
        if _recorder is None and enabled():
            slots = int(os.environ.get(
                "RAY_TPU_FLIGHT_RECORDER_SLOTS", DEFAULT_SLOTS))
            rec = FlightRecorder(slots)
            tracing.set_span_tap(rec.tap_span)
            _recorder = rec
        return _recorder


def reset_recorder() -> None:
    """Tear down the singleton + tap (tests)."""
    global _recorder
    with _recorder_lock:
        tracing.set_span_tap(None)
        _recorder = None


def record_event(name: str, detail: Any = None, *, kind: str = "event",
                 status: str = "OK") -> None:
    """Module-level convenience: record a state transition if the recorder
    is enabled (cheap no-op otherwise)."""
    rec = get_recorder()
    if rec is not None:
        rec.record_event(name, detail, kind=kind, status=status)


def trigger_dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Best-effort dump for failure-path trigger sites: records the
    trigger as a ring event, dumps, and absorbs every error (a forensics
    failure must never worsen the failure being recorded).  Returns the
    dump path, or None (disabled / suppressed / failed)."""
    rec = get_recorder()
    if rec is None:
        return None
    try:
        rec.record_event(reason, extra, kind="trigger")
        return rec.dump(reason, extra)
    except Exception:
        return None
