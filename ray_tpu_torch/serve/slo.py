"""SLO burn-rate watchdog for serve deployments (the counterpart of
``ray_tpu/serve/slo.py``).

Classic multi-window burn-rate alerting (the SRE-workbook shape) over the
signals the attribution layer (``serve/llm/attribution.py``) and the serve
RED counters feed into the process
:class:`~ray_tpu_torch.util.metrics_agent.TimeSeriesAggregator`:

- ``ttft_p99_ms``        fraction of requests whose TTFT exceeded the
  objective's threshold (exact, from per-request points)
- ``inter_token_p99_ms`` same for inter-token gaps (per-token points)
- ``availability``       error fraction from the serve RED counters

For each objective the **burn rate** is ``bad_fraction / error_budget``
where the budget is ``1 - target``: burning at 1.0 consumes the budget
exactly at the sustainable pace, at 2.0 twice as fast.  An alert fires
only when BOTH the fast and the slow window burn above the threshold —
the slow window keeps one transient blip from paging, the fast window
keeps the alert latency at one evaluation — and clears as soon as the
fast window recovers (the standard asymmetric reset).  On clear, the
whole episode exports as one retroactive ``serve.slo_burn`` span with
ERROR status, so a preemption-storm → burn → recovery sequence reads as
one story in the Perfetto timeline next to the engine's spans.

Surfaced through :func:`ray_tpu_torch.serve.api.status` (an ``"slo"`` entry
per deployment) and the metrics agent's ``/api/serve/slo`` route; the
controller's autoscale tick feeds one evaluation a tick to the SLO-burn
policy (``serve/autoscaling.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util import flight_recorder as _flight_recorder
from ray_tpu_torch.util import tracing as _tracing

#: Canonical objective names (like FAULT_POINTS and SPAN_REGISTRY).
SLO_OBJECTIVES: Dict[str, str] = {
    "ttft_p99_ms": "fraction of requests with TTFT under threshold_ms",
    "inter_token_p99_ms": "fraction of inter-token gaps under threshold_ms",
    "availability": "fraction of requests that did not error",
}

#: Objective name -> the aggregator series its bad-fraction reads
#: (latency objectives; availability derives from the RED counters).
_LATENCY_SERIES = {
    "ttft_p99_ms": "ray_tpu_llm_ttft_seconds",
    "inter_token_p99_ms": "ray_tpu_llm_inter_token_seconds",
}


@dataclass
class SLOObjective:
    """One objective: meet ``target`` fraction of good events; alert when
    the error budget (1 - target) burns ``burn_threshold``× too fast over
    both windows."""

    name: str
    target: float = 0.99
    threshold_ms: float = 250.0
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    burn_threshold: float = 2.0

    def __post_init__(self) -> None:
        if self.name not in SLO_OBJECTIVES:
            raise ValueError(
                f"unknown SLO objective {self.name!r}; registered: "
                f"{sorted(SLO_OBJECTIVES)}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.slow_window_s < self.fast_window_s:
            raise ValueError("slow_window_s must be >= fast_window_s")


def _dep_tag_candidates(deployment: str):
    cands = [{"deployment": deployment}]
    if "#" in deployment:
        cands.append({"deployment": deployment.split("#", 1)[1]})
    return cands


class SLOWatchdog:
    """Evaluates registered objectives against the process aggregator.

    Pull-model: ``evaluate()`` runs on demand (``serve.status()``, the
    ``/api/serve/slo`` scrape, tests) — no background thread to leak.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._objectives: Dict[str, List[SLOObjective]] = {}
        #: (deployment, objective name) -> {"alerting", "since"}
        self._state: Dict[Tuple[str, str], Dict[str, Any]] = {}

    # ------------------------------------------------------------- config
    def set_objectives(self, deployment: str,
                       objectives: List[SLOObjective]) -> None:
        with self._lock:
            self._objectives[str(deployment)] = list(objectives)

    def clear_objectives(self, deployment: Optional[str] = None) -> None:
        with self._lock:
            if deployment is None:
                self._objectives.clear()
                self._state.clear()
            else:
                self._objectives.pop(str(deployment), None)
                for key in [k for k in self._state
                            if k[0] == str(deployment)]:
                    self._state.pop(key)

    def has_objectives(self) -> bool:
        with self._lock:
            return bool(self._objectives)

    def deployments(self) -> List[str]:
        with self._lock:
            return sorted(self._objectives)

    # --------------------------------------------------------- evaluation
    def _bad_fraction(self, agg, deployment: str, obj: SLOObjective,
                      window_s: float, now: float) -> Tuple[float, int]:
        """(bad fraction, event count) for one objective over one window.
        No events -> (0.0, 0): silence is budget-neutral, not a burn."""
        if obj.name == "availability":
            for tags in _dep_tag_candidates(deployment):
                total = agg.window_sum("serve_requests_total", tags,
                                       window_s, now)
                if total > 0.0:
                    errors = agg.window_sum("serve_request_errors_total",
                                            tags, window_s, now)
                    return min(1.0, errors / total), int(total)
            return 0.0, 0
        series = _LATENCY_SERIES[obj.name]
        threshold_s = obj.threshold_ms / 1000.0
        for tags in _dep_tag_candidates(deployment):
            values = agg.window_values(series, tags, window_s, now)
            if values:
                bad = sum(1 for v in values if v > threshold_s)
                return bad / len(values), len(values)
        return 0.0, 0

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass over every registered objective; returns
        the full per-deployment payload (what ``/api/serve/slo`` serves)
        and updates alert state, emitting a ``serve.slo_burn`` span when
        an episode closes."""
        from ray_tpu_torch.util.metrics_agent import get_aggregator

        agg = get_aggregator()
        agg.sample_registry()  # fold current counters/gauges into the window
        t = time.time() if now is None else float(now)
        with self._lock:
            objectives = {d: list(objs)
                          for d, objs in self._objectives.items()}
        payload: Dict[str, Any] = {}
        for deployment, objs in objectives.items():
            dep_out: Dict[str, Any] = {}
            for obj in objs:
                budget = 1.0 - obj.target
                bad_fast, n_fast = self._bad_fraction(
                    agg, deployment, obj, obj.fast_window_s, t)
                bad_slow, n_slow = self._bad_fraction(
                    agg, deployment, obj, obj.slow_window_s, t)
                burn_fast = bad_fast / budget
                burn_slow = bad_slow / budget
                alerting, fired = self._update_state(
                    deployment, obj, burn_fast, burn_slow, t)
                if fired:
                    # Breach forensics, outside the watchdog lock: the
                    # black box still holds the requests that burned the
                    # budget (best-effort, flood-controlled per reason).
                    _flight_recorder.trigger_dump("slo_breach", {
                        "deployment": deployment, "objective": obj.name,
                        "burn_fast": round(burn_fast, 4),
                        "burn_slow": round(burn_slow, 4),
                    })
                dep_out[obj.name] = {
                    "target": obj.target,
                    "threshold_ms": obj.threshold_ms,
                    "fast_window_s": obj.fast_window_s,
                    "slow_window_s": obj.slow_window_s,
                    "burn_threshold": obj.burn_threshold,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "bad_fraction_fast": round(bad_fast, 4),
                    "bad_fraction_slow": round(bad_slow, 4),
                    "events_fast": n_fast,
                    "events_slow": n_slow,
                    "alerting": alerting,
                    "since": self._state.get(
                        (deployment, obj.name), {}).get("since"),
                }
            payload[deployment] = {
                "objectives": dep_out,
                "alerting": any(o["alerting"] for o in dep_out.values()),
            }
        return payload

    def _update_state(self, deployment: str, obj: SLOObjective,
                      burn_fast: float, burn_slow: float,
                      now: float) -> Tuple[bool, bool]:
        """Returns (alerting, fired): ``fired`` is True only on the
        not-alerting -> alerting transition, so the caller can trigger the
        postmortem dump outside this lock."""
        key = (deployment, obj.name)
        fired = False
        with self._lock:
            state = self._state.setdefault(
                key, {"alerting": False, "since": None})
            if not state["alerting"]:
                # Fire only when BOTH windows burn: the slow window vetoes
                # one-blip pages, the fast window bounds detection latency.
                if burn_fast >= obj.burn_threshold \
                        and burn_slow >= obj.burn_threshold:
                    state["alerting"] = True
                    state["since"] = now
                    fired = True
            elif burn_fast < obj.burn_threshold:
                # Fast-window recovery clears (asymmetric reset) and the
                # whole episode becomes one timeline span.
                start = state["since"] or now
                state["alerting"] = False
                state["since"] = None
                _tracing.record_span(
                    "serve.slo_burn", start, now,
                    attributes={"deployment": deployment,
                                "objective": obj.name,
                                "burn_fast": round(burn_fast, 4),
                                "burn_slow": round(burn_slow, 4)},
                    status="ERROR: SLOBurn")
            return state["alerting"], fired

    def alerting(self, deployment: str) -> bool:
        """Is any objective of this deployment currently alerting (as of
        the last ``evaluate()``)?"""
        with self._lock:
            return any(state["alerting"]
                       for (dep, _), state in self._state.items()
                       if dep == deployment)


_watchdog: Optional[SLOWatchdog] = None
_watchdog_lock = threading.Lock()


def get_watchdog() -> SLOWatchdog:
    """The process-wide watchdog (what serve.status() and the agent's
    ``/api/serve/slo`` route consult)."""
    global _watchdog
    with _watchdog_lock:
        if _watchdog is None:
            _watchdog = SLOWatchdog()
        return _watchdog


def _reset_watchdog() -> None:
    """Test hook: drop all objectives and alert state."""
    global _watchdog
    with _watchdog_lock:
        _watchdog = None
