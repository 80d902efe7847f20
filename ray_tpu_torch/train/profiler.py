"""Per-step train profiler: wall-time attribution, live MFU, step spans
(the counterpart of ``ray_tpu/train/profiler.py``).

Every training step's wall clock — one ``report()`` to the next — is
attributed into

* ``data_wait``   — blocked on the input pipeline (prefetch starvation,
  elastic ledger claim + fetch);
* ``h2d``         — host→device transfer dispatch
  (:class:`~ray_tpu_torch.data.ingest.prefetch.DeviceBatchIterator`);
* ``collective``  — gradient-sync rendezvous (entering a collective to
  getting its result back);
* ``ckpt_block``  — the device→host snapshot an async checkpoint save
  blocks the step for (the reference's ``ShardWriter.save_async``; the
  port's async save waits for its ``checkpoint/`` package);
* ``compute``     — the residual.  Defining compute as ``wall − Σ other``
  makes the buckets sum to the measured wall time *by construction* —
  un-instrumented host work lands in compute rather than vanishing.

The profiler is **per worker thread** (thread-local, like the session it
belongs to), so ``record()`` needs no lock: every hook site — prefetcher
consumption, device transfer, collective contribute, snapshot — runs on
the worker's own thread.  Hook modules outside ``train/`` reach it
through a ``sys.modules`` probe (see :func:`record`'s callers), so they
never import the train package and pay one dict lookup when training is
not in the process at all.

Step closure (``step_boundary``, called from ``TrainSession.report``)
emits the tracing spans retroactively — a ``train.step`` parent
span with one child span per recorded interval — and refreshes the
``ray_tpu_train_*`` gauges (MFU, tokens/s, step-time p50/p95, data-
starved fraction).  Spans cost nothing when tracing is off; the whole
profiler is skipped when ``RunConfig(profile=False)``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train import metrics as train_metrics
from ray_tpu_torch.util import tracing, watchdog

#: Attribution buckets measured by hooks; ``compute`` is the residual.
BUCKETS = ("data_wait", "h2d", "collective", "ckpt_block")

#: Per-bucket cap on *span* intervals kept per step — totals always
#: accumulate, but a step with thousands of tiny waits must not emit
#: thousands of spans.
_MAX_INTERVALS = 64

#: Recent step walls for the live p50/p95 gauges (sliding, not lifetime —
#: a regression shows up within a window, not diluted by history).
_PCTL_WINDOW = 128

_local = threading.local()


class StepProfiler:
    """Wall-time attribution for one worker's training steps.

    Lives on the worker's :class:`~ray_tpu_torch.train.session.TrainSession`;
    activated/deactivated with the session itself (``init_session`` /
    ``clear_session``).  All methods are called from the worker thread.
    """

    def __init__(self, run_name: str = "", rank: int = 0,
                 flops_per_step: Optional[float] = None,
                 tokens_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 history_steps: int = 512):
        self.run_name = run_name
        self.rank = rank
        self.flops_per_step = flops_per_step
        self.tokens_per_step = tokens_per_step
        self.peak_flops = peak_flops
        #: per-step attribution rows (bounded) — the bench and the state
        #: API read these; each row's buckets sum to its wall.
        self.history: "deque" = deque(maxlen=history_steps)
        # Lock-free by thread-local discipline: the profiler is reached
        # through ``_local`` so every hook site runs on the worker's own
        # thread — the ownership labels document (and let the analyzer
        # police) that no spawned thread may touch the step state.
        self._step = 0  # owned_by_thread: worker thread (thread-local _local)
        self._step_start: Optional[float] = None  # owned_by_thread: worker thread (thread-local _local)
        self._totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}  # owned_by_thread: worker thread (thread-local _local)
        self._intervals: Dict[str, List[Tuple[float, float]]] = {  # owned_by_thread: worker thread (thread-local _local)
            b: [] for b in BUCKETS}
        self._recent_walls: "deque" = deque(maxlen=_PCTL_WINDOW)  # owned_by_thread: worker thread (thread-local _local)

    # ------------------------------------------------------------- config
    def configure(self, *, flops_per_step: Optional[float] = None,
                  tokens_per_step: Optional[float] = None,
                  peak_flops: Optional[float] = None) -> None:
        """Set the MFU/throughput inputs (typically once, from inside the
        train loop, after the model is built)."""
        if flops_per_step is not None:
            self.flops_per_step = float(flops_per_step)
        if tokens_per_step is not None:
            self.tokens_per_step = float(tokens_per_step)
        if peak_flops is not None:
            self.peak_flops = float(peak_flops)

    # -------------------------------------------------------------- hooks
    def start(self, now: Optional[float] = None) -> None:
        """Open the first step window (activation time)."""
        if self._step_start is None:
            self._step_start = time.time() if now is None else now

    def record(self, bucket: str, start: float, end: float) -> None:
        """Attribute [start, end] (``time.time()`` seconds) to a bucket.

        Called from the hook sites on the worker thread; must stay cheap
        — two dict lookups, an add and (usually) an append."""
        dur = end - start
        if dur <= 0.0:
            return
        self._totals[bucket] += dur
        iv = self._intervals[bucket]
        if len(iv) < _MAX_INTERVALS:
            iv.append((start, end))
        if self._step_start is None:
            self._step_start = start

    # ----------------------------------------------------------- boundary
    def step_boundary(self, now: Optional[float] = None) -> Optional[dict]:
        """Close the current step: attribute its wall, emit spans, refresh
        the live gauges.  Returns the attribution row (or None before the
        first window opened)."""
        t1 = time.time() if now is None else now
        t0 = self._step_start
        if t0 is None or t1 <= t0:
            self._reset(t1)
            return None
        wall = t1 - t0
        totals = {b: min(self._totals[b], wall) for b in BUCKETS}
        compute = max(0.0, wall - sum(totals.values()))
        row = {"step": self._step, "wall": wall, "compute": compute,
               **totals}
        self.history.append(row)
        # Progress heartbeat: step closure feeds the hang watchdog (stall
        # = beats stop) and the straggler check (cross-worker dispersion
        # of these walls).
        watchdog.beat(f"train:{self.run_name}:{self.rank}", wall=wall)
        self._emit_spans(t0, t1, compute, row)
        self._update_metrics(wall, totals, row)
        self._step += 1
        self._reset(t1)
        return row

    def _reset(self, t1: float) -> None:
        self._step_start = t1
        for b in BUCKETS:
            self._totals[b] = 0.0
            self._intervals[b].clear()

    # -------------------------------------------------------------- spans
    def _emit_spans(self, t0: float, t1: float, compute: float,
                    row: dict) -> None:
        if not tracing.is_tracing_enabled():
            return
        parent = tracing.record_span(
            "train.step", t0, t1,
            attributes={"step": row["step"], "rank": self.rank,
                        "run": self.run_name,
                        "compute_s": round(compute, 6)})
        if parent is None:
            return
        iv = self._intervals
        tracing.record_span_batch(
            "train.data_wait", [(s, e, parent) for s, e in iv["data_wait"]])
        tracing.record_span_batch(
            "train.h2d", [(s, e, parent) for s, e in iv["h2d"]])
        tracing.record_span_batch(
            "train.collective",
            [(s, e, parent) for s, e in iv["collective"]])
        tracing.record_span_batch(
            "train.ckpt_block",
            [(s, e, parent) for s, e in iv["ckpt_block"]])
        if compute > 0.0:
            # The residual has no measured interval; render it anchored at
            # the step start so the lane shows its share of the step.
            tracing.record_span("train.compute", t0, t0 + compute,
                                parent=parent,
                                attributes={"residual": True})

    # ------------------------------------------------------------- gauges
    def _update_metrics(self, wall: float, totals: Dict[str, float],
                        row: dict) -> None:
        m = train_metrics
        m.STEPS_PROFILED.inc()
        m.STEP_SECONDS.observe(wall)
        self._recent_walls.append(wall)
        walls = sorted(self._recent_walls)
        m.STEP_P50_SECONDS.set(walls[len(walls) // 2])
        m.STEP_P95_SECONDS.set(walls[min(len(walls) - 1,
                                         int(len(walls) * 0.95))])
        m.DATA_STARVED_FRACTION.set(totals["data_wait"] / wall)
        for bucket, dur in totals.items():
            m.STEP_BUCKET_SECONDS.set(dur, {"bucket": bucket})
        m.STEP_BUCKET_SECONDS.set(row["compute"], {"bucket": "compute"})
        if self.tokens_per_step:
            m.TOKENS_PER_SECOND.set(self.tokens_per_step / wall)
        if self.flops_per_step and self.peak_flops:
            m.MFU.set(self.flops_per_step / wall / self.peak_flops)

    # ------------------------------------------------------------ queries
    def last_attribution(self) -> Optional[dict]:
        return self.history[-1] if self.history else None


# ---------------------------------------------------------------- thread API
def activate(profiler: Optional[StepProfiler]) -> None:
    """Bind a profiler to the calling thread (the session lifecycle calls
    this; ``None`` unbinds)."""
    _local.profiler = profiler
    if profiler is not None:
        profiler.start()


def active_profiler() -> Optional[StepProfiler]:
    return getattr(_local, "profiler", None)


def record(bucket: str, start: float, end: float) -> None:
    """Hook entry point: attribute an interval to the calling thread's
    profiler; no-op when the thread isn't a profiled train worker.

    Modules outside ``train/`` must not import this package for it (the
    train package import pulls the trainer → collective chain); they probe
    ``sys.modules.get("ray_tpu_torch.train.profiler")`` instead — if the module
    was never imported, no profiler can be active anywhere.
    """
    p = getattr(_local, "profiler", None)
    if p is not None:
        p.record(bucket, start, end)


def configure(**kwargs: Any) -> None:
    """Set MFU/throughput inputs on the calling worker's profiler (no-op
    outside a profiled train loop) — see :meth:`StepProfiler.configure`."""
    p = getattr(_local, "profiler", None)
    if p is not None:
        p.configure(**kwargs)
