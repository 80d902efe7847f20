"""Hang/straggler watchdog: detects the failures liveness polls cannot
(the counterpart of ``ray_tpu/util/watchdog.py``).

The runtime's 250 ms liveness poll answers "is the process alive" — a
trainer wedged inside a collective rendezvous, a replica lane that stopped
draining, or a worker 3× slower than its peers is *alive* and invisible to
it.  This watchdog tracks **progress** instead:

* ``beat(source, wall=...)`` — periodic progress heartbeats: step closure
  from :mod:`ray_tpu_torch.train.profiler` (the compiled router's lane
  ticks come with that router, ROADMAP.md Queue 1 item 13.5);
* ``phase_enter(source, phase)`` / ``phase_exit(source)`` — bounded-phase
  tracking: collective rendezvous entry/exit in
  :mod:`ray_tpu_torch.collective.thread_group` (a phase held open past the
  stall threshold is a wedge even while beats from other threads
  continue).

``tick()`` (driven by a lazily-started daemon thread, or called directly
with a deterministic clock in tests) flags a **stall** when a source's
last progress — beat or open phase — is older than the threshold: it
captures all-thread stacks into the flight-recorder ring, emits the
``ray_tpu_stall_*`` metrics and a retroactive ``train.stall`` ERROR span
(so the wedge renders in the Perfetto train lane), and samples coarse
metric deltas into the ring.  **Stragglers** are flagged from cross-worker
step-time dispersion: a source whose recent median step wall exceeds
``straggler_factor ×`` the cluster median.  Disable the background thread
with ``RAY_TPU_HANG_WATCHDOG=0``; ``tick()`` still works for tests.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import flight_recorder, metrics, tracing

DEFAULT_STALL_THRESHOLD_S = 30.0
DEFAULT_TICK_INTERVAL_S = 5.0
DEFAULT_STRAGGLER_FACTOR = 2.0
#: Recent step walls kept per source for the dispersion check.
_WALL_WINDOW = 32
#: A beat-quiet source retires (drops out of stall accounting) after this
#: many stall thresholds — a finished worker is not a permanent wedge.
_RETIRE_FACTOR = 10.0

STALL_EVENTS_TOTAL = metrics.Counter(
    "ray_tpu_stall_events_total",
    "Progress stalls detected by the hang watchdog, by kind "
    "(phase = wedged inside a bounded phase, beat = heartbeats stopped).",
    ("kind", "source"))
STALLED_SOURCES = metrics.Gauge(
    "ray_tpu_stall_active",
    "Sources currently considered stalled by the hang watchdog.")
STRAGGLER_SOURCES = metrics.Gauge(
    "ray_tpu_stall_stragglers",
    "Sources whose recent median step wall exceeds the cluster median by "
    "the straggler dispersion factor.")


class HangWatchdog:
    """Progress tracking + stall/straggler detection for one process."""

    def __init__(self, *,
                 stall_threshold_s: Optional[float] = None,
                 straggler_factor: Optional[float] = None):
        self.stall_threshold_s = float(
            stall_threshold_s if stall_threshold_s is not None
            else os.environ.get("RAY_TPU_STALL_THRESHOLD_S",
                                DEFAULT_STALL_THRESHOLD_S))
        self.straggler_factor = float(
            straggler_factor if straggler_factor is not None
            else os.environ.get("RAY_TPU_STRAGGLER_FACTOR",
                                DEFAULT_STRAGGLER_FACTOR))
        self._lock = threading.Lock()
        #: source -> progress row {"last_beat", "phase", "phase_t0",
        #: "walls", "stalled", "straggler"}
        self._sources: Dict[str, Dict[str, Any]] = {}  # guarded_by: _lock
        self._thread: Optional[threading.Thread] = None  # guarded_by: _lock

    # ------------------------------------------------------------ progress
    def _row_locked(self, source: str, now: float) -> Dict[str, Any]:
        row = self._sources.get(source)
        if row is None:
            row = {"last_beat": now, "phase": None, "phase_t0": 0.0,
                   "walls": deque(maxlen=_WALL_WINDOW), "stalled": False,
                   "straggler": False}
            self._sources[source] = row
        return row

    def beat(self, source: str, wall: Optional[float] = None,
             now: Optional[float] = None) -> None:
        """Progress heartbeat; ``wall`` (seconds) feeds the straggler
        dispersion check.  Cheap: one lock round-trip, no allocation after
        the source's first beat."""
        t = time.time() if now is None else now
        with self._lock:
            row = self._row_locked(source, t)
            row["last_beat"] = t
            if wall is not None:
                row["walls"].append(wall)

    def phase_enter(self, source: str, phase: str,
                    now: Optional[float] = None) -> None:
        """Mark entry into a bounded phase (collective rendezvous, channel
        drain) — held open past the threshold it is a stall even while the
        process stays responsive."""
        t = time.time() if now is None else now
        with self._lock:
            row = self._row_locked(source, t)
            row["phase"] = phase
            row["phase_t0"] = t
            row["last_beat"] = t

    def phase_exit(self, source: str, now: Optional[float] = None) -> None:
        t = time.time() if now is None else now
        with self._lock:
            row = self._sources.get(source)
            if row is not None:
                row["phase"] = None
                row["last_beat"] = t

    def forget(self, source: str) -> None:
        """Drop a source (worker retired/descaled) so it cannot stall."""
        with self._lock:
            self._sources.pop(source, None)

    # ----------------------------------------------------------- detection
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One detection pass; returns the stall records found this pass
        (new stalls only — a wedge is reported once, then armed again when
        progress resumes).  Deterministic under an injected clock."""
        t = time.time() if now is None else now
        new_stalls: List[dict] = []
        stalled_count = 0
        straggler_count = 0
        with self._lock:
            medians = {}
            for source, row in self._sources.items():
                walls = sorted(row["walls"])
                if walls:
                    medians[source] = walls[len(walls) // 2]
            cluster = sorted(medians.values())
            cluster_median = (cluster[len(cluster) // 2] if cluster else 0.0)
            for source, row in list(self._sources.items()):
                if row["phase"] is None and t - row["last_beat"] \
                        > _RETIRE_FACTOR * self.stall_threshold_s:
                    # Source went quiet long ago (worker retired, lane
                    # closed without forget()): stop reporting it as
                    # stalled — its one-shot stall record already fired.
                    self._sources.pop(source)
                    continue
                if row["phase"] is not None \
                        and t - row["phase_t0"] > self.stall_threshold_s:
                    kind, since = "phase", row["phase_t0"]
                elif t - row["last_beat"] > self.stall_threshold_s:
                    kind, since = "beat", row["last_beat"]
                else:
                    row["stalled"] = False
                    kind = None
                if kind is not None:
                    stalled_count += 1
                    if not row["stalled"]:
                        row["stalled"] = True
                        new_stalls.append({
                            "source": source, "kind": kind, "since": since,
                            "phase": row["phase"], "detected": t})
                m = medians.get(source)
                row["straggler"] = bool(
                    m is not None and len(medians) >= 2
                    and cluster_median > 0.0
                    and m > self.straggler_factor * cluster_median)
                straggler_count += row["straggler"]
        STALLED_SOURCES.set(stalled_count)
        STRAGGLER_SOURCES.set(straggler_count)
        for stall in new_stalls:
            self._report_stall(stall)
        rec = flight_recorder.get_recorder()
        if rec is not None:
            rec.sample_metric_deltas(now=t)
        # Drive the recompile-storm detector on the same cadence (probed,
        # not imported — a process that never loaded the device-telemetry
        # plane pays one dict miss per tick).
        telemetry = sys.modules.get("ray_tpu_torch.util.device_telemetry")
        if telemetry is not None:
            try:
                telemetry.storm_tick(now=t)
            except Exception:
                pass  # detection is best-effort, same as the loop's ticks
        return new_stalls

    def _report_stall(self, stall: dict) -> None:
        """Stacks into the black box + metrics + a timeline span — outside
        the watchdog lock (stack capture walks every thread's frames)."""
        STALL_EVENTS_TOTAL.inc(tags={"kind": stall["kind"],
                                     "source": stall["source"]})
        rec = flight_recorder.get_recorder()
        if rec is not None:
            try:
                from ray_tpu_torch._private import stack_profiler

                rec.record_event(
                    f"stall:{stall['source']}",
                    {"kind": stall["kind"], "phase": stall["phase"],
                     "since": stall["since"],
                     "stacks": stack_profiler.current_process_stacks()},
                    now=stall["detected"], kind="stall", status="ERROR")
            except Exception:
                pass  # forensics must never worsen the stall
        tracing.record_span(
            "train.stall", stall["since"], stall["detected"],
            attributes={"source": stall["source"], "kind": stall["kind"],
                        "phase": stall["phase"]},
            status="ERROR: Stall")

    def straggler_report(self) -> Dict[str, dict]:
        """source -> {"median_wall", "straggler"} as of the last tick."""
        with self._lock:
            out = {}
            for source, row in self._sources.items():
                walls = sorted(row["walls"])
                out[source] = {
                    "median_wall": walls[len(walls) // 2] if walls else None,
                    "straggler": row["straggler"],
                    "stalled": row["stalled"],
                }
            return out

    # ----------------------------------------------------- background loop
    def ensure_started(self) -> None:
        """Start the detection thread once (no-op when disabled via
        RAY_TPU_HANG_WATCHDOG=0, or already running)."""
        if os.environ.get("RAY_TPU_HANG_WATCHDOG", "1") == "0":
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            t = threading.Thread(target=self._run_loop,
                                 name="ray_tpu_hang_watchdog", daemon=True)
            self._thread = t
        t.start()  # detached_ok: daemon detection loop, dies with the process

    def _run_loop(self) -> None:
        interval = float(os.environ.get("RAY_TPU_WATCHDOG_TICK_S",
                                        DEFAULT_TICK_INTERVAL_S))
        while True:
            time.sleep(interval)
            try:
                self.tick()
            except Exception:
                pass  # detection is best-effort; never kill the thread


# ------------------------------------------------------------------ singleton
_watchdog: Optional[HangWatchdog] = None  # guarded_by: _watchdog_lock
_watchdog_lock = threading.Lock()


def get_watchdog() -> HangWatchdog:
    global _watchdog
    with _watchdog_lock:
        if _watchdog is None:
            _watchdog = HangWatchdog()
        return _watchdog


def reset_watchdog() -> None:
    """Test hook: drop all progress state (the detection thread, if
    started, keeps running against the new instance on its next tick)."""
    global _watchdog
    with _watchdog_lock:
        _watchdog = None


def beat(source: str, wall: Optional[float] = None) -> None:
    """Hook entry for heartbeat sites (step closure, lane drain): records
    progress and lazily starts the detection thread."""
    wd = get_watchdog()
    wd.beat(source, wall)
    wd.ensure_started()


def phase_enter(source: str, phase: str) -> None:
    """Hook entry for bounded-phase sites (rendezvous enter)."""
    wd = get_watchdog()
    wd.phase_enter(source, phase)
    wd.ensure_started()


def phase_exit(source: str) -> None:
    get_watchdog().phase_exit(source)


def forget(source: str) -> None:
    """Hook entry for retirement sites (a stopped autoscaler monitor, a
    descaled worker): drop the source so it cannot be flagged as a stall."""
    get_watchdog().forget(source)
