"""SLO-driven serve autoscaling policies (per deployment; the counterpart
of ``ray_tpu/serve/autoscaling.py``).

The policy layer between sensing (windowed accessors in ``serve.metrics``,
the multi-window burn-rate watchdog in ``serve.slo``) and actuation
(``DeploymentState.set_target_num``).  Three desired-count policies are
composed by max — any policy can force capacity up, all must agree before
it comes down (ref: serve/autoscaling_policy.py — request-driven policy;
the burn-rate composition follows the multiwindow alerting practice the
SLO watchdog implements):

- **queue depth**: handle-reported in-flight requests vs
  ``target_ongoing_requests``.
- **target qps**: windowed ``request_rate`` vs ``target_qps_per_replica``,
  with saturated continuous batches (``batch_occupancy`` >= 0.95) forcing
  one extra replica.
- **SLO burn**: while the fast-window burn is alerting, multiply the target
  by ``burn_upscale_factor`` and bypass the upscale hysteresis delay;
  scale-down is held until every window of every objective is quiet.

Asymmetric hysteresis (``upscale_delay_s`` / ``downscale_delay_s``),
per-direction cooldowns, a crash-loop interlock (a deployment in start
backoff never moves its target), scale-to-zero after idle, and immediate
wake-from-zero when requests queue at routers with nothing running.

All state is keyed on the caller-supplied ``PolicyInputs.now`` so the layer
is deterministic under test.  The controller owns the apply site: it
consults the ``serve_autoscale`` fault point *before* calling
``set_target_num`` (an injected decision failure leaves the target
unchanged) and records every applied change here — metrics plus a
flight-recorder row.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

from ray_tpu_torch.serve.config import AutoscalingConfig
from ray_tpu_torch.util import metrics as _metrics

DECISIONS = _metrics.Counter(
    "ray_tpu_serve_autoscale_decisions_total",
    "Autoscale decisions applied or rejected, by outcome reason",
    tag_keys=("deployment", "reason"))
SCALE_UP = _metrics.Counter(
    "ray_tpu_serve_autoscale_scale_up_total",
    "Applied target increases per deployment",
    tag_keys=("deployment",))
SCALE_DOWN = _metrics.Counter(
    "ray_tpu_serve_autoscale_scale_down_total",
    "Applied target decreases per deployment",
    tag_keys=("deployment",))
TARGET_REPLICAS = _metrics.Gauge(
    "ray_tpu_serve_autoscale_target_replicas",
    "Current autoscaler-set replica target per deployment",
    tag_keys=("deployment",))
WARM_POOL_SIZE = _metrics.Gauge(
    "ray_tpu_serve_autoscale_warm_pool_size",
    "Pre-started warm replicas held outside the serving set",
    tag_keys=("deployment",))
COLD_STARTS = _metrics.Counter(
    "ray_tpu_serve_autoscale_cold_starts_total",
    "Scale-up replica starts that could not be served from the warm pool",
    tag_keys=("deployment",))
WARM_PROMOTIONS = _metrics.Counter(
    "ray_tpu_serve_autoscale_warm_promotions_total",
    "Scale-up events satisfied by promoting a pre-started warm replica",
    tag_keys=("deployment",))


@dataclass
class PolicyInputs:
    """One sensing snapshot for one deployment, all fields explicit so unit
    tests drive the policy with a deterministic clock."""

    now: float
    num_running: int
    target_num: int
    total_inflight: int = 0
    #: Requests parked in router dispatch loops with no replica to take them
    #: (the zero->one wake signal; see Router._dispatch).
    queued_requests: int = 0
    request_rate: float = 0.0
    batch_occupancy: float = 0.0
    #: SLO watchdog fast-window burn alerting for this deployment.
    burn_alerting: bool = False
    #: True when every window of every objective is under threshold.
    burn_quiet: bool = True
    #: Deployment is in crash-loop start backoff.
    in_backoff: bool = False


@dataclass
class Decision:
    target: int
    reason: str
    changed: bool


class DeploymentAutoscaler:
    """Hysteresis + cooldown state machine around the composed policies."""

    def __init__(self, deployment_id: str, config: AutoscalingConfig):
        self.deployment_id = deployment_id
        self.config = config
        #: Last wall-clock the controller fed this scaler (rate-limits
        #: evaluation to config.metrics_interval_s).
        self.last_check = 0.0
        self.last_reason: Optional[str] = None
        self.last_change_at: Optional[float] = None
        self._above_since = -1.0
        self._below_since = -1.0
        self._last_up_at = -math.inf
        self._last_down_at = -math.inf
        self._idle_since: Optional[float] = None

    # ------------------------------------------------------------- policies
    def _desired(self, inp: PolicyInputs) -> Tuple[int, str]:
        cfg = self.config
        desired = math.ceil(inp.total_inflight / cfg.target_ongoing_requests)
        reason = "queue_depth"
        if cfg.target_qps_per_replica:
            d_qps = math.ceil(inp.request_rate / cfg.target_qps_per_replica)
            if inp.batch_occupancy >= 0.95 and inp.num_running > 0:
                d_qps = max(d_qps, inp.num_running + 1)
            if d_qps > desired:
                desired, reason = d_qps, "target_qps"
        if cfg.use_slo_burn and inp.burn_alerting:
            d_burn = max(inp.target_num + 1,
                         math.ceil(inp.target_num * cfg.burn_upscale_factor))
            if d_burn > desired:
                desired, reason = d_burn, "slo_burn"
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        return desired, reason

    # ------------------------------------------------------------- decision
    def decide(self, inp: PolicyInputs) -> Decision:
        cfg, now, target = self.config, inp.now, inp.target_num
        decision = self._decide(inp, cfg, now, target)
        self.last_reason = decision.reason
        if decision.changed:
            self.last_change_at = now
        return decision

    def _decide(self, inp: PolicyInputs, cfg: AutoscalingConfig,
                now: float, target: int) -> Decision:
        if inp.in_backoff:
            # Crash-loop interlock: starts are already gated by backoff;
            # moving the target would only queue flapping for later.
            self._above_since = self._below_since = -1.0
            return Decision(target, "crash_loop_backoff", False)

        # Wake-from-zero: queued demand with a zero target is served
        # immediately — no hysteresis, no cooldown (the queued requests are
        # already paying the latency).
        if target <= 0 and inp.queued_requests > 0:
            self._idle_since = None
            self._above_since = self._below_since = -1.0
            self._last_up_at = now
            desired, _ = self._desired(inp)
            return Decision(max(1, min(max(desired, cfg.min_replicas),
                                       cfg.max_replicas)),
                            "wake_from_zero", True)

        desired, reason = self._desired(inp)

        busy = (inp.total_inflight > 0 or inp.queued_requests > 0
                or inp.request_rate > 0 or inp.burn_alerting)
        if busy:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        if desired > target:
            self._below_since = -1.0
            if self._above_since < 0:
                self._above_since = now
            waited = now - self._above_since
            # Burn alerting scales up aggressively: the hysteresis delay is
            # bypassed (the cooldown still spaces consecutive ups).
            ready = (reason == "slo_burn") or waited >= cfg.upscale_delay_s
            if ready and now - self._last_up_at >= cfg.upscale_cooldown_s:
                self._above_since = -1.0
                self._last_up_at = now
                return Decision(desired, reason, True)
            return Decision(target, f"pending_up:{reason}", False)
        self._above_since = -1.0

        if cfg.min_replicas == 0 and target > 0 and not busy \
                and inp.burn_quiet and self._idle_since is not None \
                and now - self._idle_since >= cfg.scale_to_zero_idle_s \
                and now - self._last_down_at >= cfg.downscale_cooldown_s:
            self._below_since = -1.0
            self._last_down_at = now
            return Decision(0, "scale_to_zero", True)

        if desired < target:
            if not inp.burn_quiet:
                # Down only when all windows are quiet.
                self._below_since = -1.0
                return Decision(target, "hold_burn_not_quiet", False)
            if self._below_since < 0:
                self._below_since = now
            # Step down one replica per decision: a drain never races a
            # mass shrink.
            floor = cfg.min_replicas if cfg.min_replicas > 0 else 1
            new = max(target - 1, desired, floor)
            if new == target:
                # Clamped at the floor (e.g. min_replicas=0 holding at one
                # replica until scale-to-zero idles out): no change, and no
                # cooldown burned.
                return Decision(target, "at_floor", False)
            if now - self._below_since >= cfg.downscale_delay_s \
                    and now - self._last_down_at >= cfg.downscale_cooldown_s:
                self._below_since = -1.0
                self._last_down_at = now
                return Decision(new, "scale_down", True)
            return Decision(target, "pending_down", False)
        self._below_since = -1.0
        return Decision(target, "steady", False)


# ----------------------------------------------------------------- recording
def record_applied(deployment_id: str, old: int, new: int,
                   reason: str) -> None:
    """Account an applied target change: metrics + flight-recorder row."""
    DECISIONS.inc(1, tags={"deployment": deployment_id, "reason": reason})
    if new > old:
        SCALE_UP.inc(1, tags={"deployment": deployment_id})
    else:
        SCALE_DOWN.inc(1, tags={"deployment": deployment_id})
    TARGET_REPLICAS.set(new, tags={"deployment": deployment_id})
    from ray_tpu_torch.util import flight_recorder
    flight_recorder.record_event(
        "serve.autoscale",
        {"deployment": deployment_id, "from": old, "to": new,
         "reason": reason},
        kind="autoscale")


def record_rejected(deployment_id: str) -> None:
    """An injected scale-decision failure left the target unchanged."""
    DECISIONS.inc(1, tags={"deployment": deployment_id,
                           "reason": "fault_injected"})
