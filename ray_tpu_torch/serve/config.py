"""Serve configuration schemas (the counterpart of ``ray_tpu/serve/config.py``;
ref: python/ray/serve/config.py — AutoscalingConfig, HTTPOptions;
python/ray/serve/_private/config.py DeploymentConfig).

The gRPC options come with the gRPC proxy (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class AutoscalingConfig:
    """(ref: serve/config.py AutoscalingConfig — request-based policy driven
    by handle-reported queue metrics, extended with target-qps and SLO
    burn-rate policies, scale-to-zero, and warm pools).

    Desired counts from the enabled policies (queue depth, target-qps, SLO
    burn) are composed by max — any policy can force capacity up, all must
    agree before it comes down.
    """

    #: 0 enables scale-to-zero: after ``scale_to_zero_idle_s`` of no traffic
    #: the deployment drops its last replica; the first request after idle
    #: queues at the router until the controller wakes a replica (promoted
    #: from the warm pool when one is configured).
    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    metrics_interval_s: float = 1.0
    initial_replicas: Optional[int] = None
    #: Per-replica sustainable request rate; enables the target-qps policy
    #: (windowed ``serve.metrics.request_rate`` / this), with saturated
    #: continuous batches (``batch_occupancy`` >= 0.95) forcing one extra
    #: replica even when the rate alone would not.
    target_qps_per_replica: Optional[float] = None
    #: Window for the request-rate sample feeding the target-qps policy.
    qps_window_s: float = 10.0
    #: Let the SLO burn-rate watchdog (serve/slo.py) drive scaling: while a
    #: fast-window burn is alerting, upscale bypasses the hysteresis delay
    #: and multiplies the target by ``burn_upscale_factor``; scale-down is
    #: held until every window of every objective is quiet.
    use_slo_burn: bool = True
    burn_upscale_factor: float = 2.0
    #: Per-direction cooldowns — minimum spacing between consecutive scale
    #: events in the same direction, independent of the hysteresis delays.
    upscale_cooldown_s: float = 5.0
    downscale_cooldown_s: float = 30.0
    #: Idle time (no in-flight, queued, or arriving requests) before a
    #: min_replicas=0 deployment drops to zero replicas.
    scale_to_zero_idle_s: float = 60.0
    #: Replicas kept pre-started (constructed, health-checked) outside the
    #: serving set; scale-up promotes one of these instead of paying a cold
    #: start (for a model replica: the weights' load and placement).
    warm_pool_size: int = 0
    #: Multiplexed model ids to pre-load on each warm replica via the
    #: ``_ModelMultiplexWrapper`` load path (serve/multiplex.py) so a
    #: promotion does not pay the weights' load either.
    prewarm_model_ids: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.min_replicas < 0:
            raise ValueError(
                f"min_replicas must be >= 0, got {self.min_replicas}")
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                f"max_replicas must be >= max(1, min_replicas), got "
                f"max_replicas={self.max_replicas} with "
                f"min_replicas={self.min_replicas}")
        if self.initial_replicas is not None and not (
                self.min_replicas <= self.initial_replicas
                <= self.max_replicas):
            raise ValueError(
                f"initial_replicas={self.initial_replicas} outside "
                f"[{self.min_replicas}, {self.max_replicas}]")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")
        if self.target_qps_per_replica is not None \
                and self.target_qps_per_replica <= 0:
            raise ValueError("target_qps_per_replica must be > 0")
        if self.warm_pool_size < 0:
            raise ValueError("warm_pool_size must be >= 0")
        for name in ("upscale_delay_s", "downscale_delay_s",
                     "metrics_interval_s", "qps_window_s",
                     "upscale_cooldown_s", "downscale_cooldown_s",
                     "scale_to_zero_idle_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.burn_upscale_factor < 1.0:
            raise ValueError("burn_upscale_factor must be >= 1.0")

    @classmethod
    def default(cls) -> "AutoscalingConfig":
        """The config ``num_replicas="auto"`` wires (ref: serve/config.py
        AutoscalingConfig.default — 1..inf with target 2; bounded here)."""
        return cls(min_replicas=1, max_replicas=8,
                   target_ongoing_requests=2.0)


@dataclass
class DeploymentConfig:
    """(ref: serve/_private/config.py DeploymentConfig)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 5
    #: Queue allowance beyond the replicas' combined max_ongoing_requests
    #: before routers shed with BackPressureError (HTTP 503 at the proxy).
    #: -1 (default) = unbounded: excess requests queue in replica mailboxes.
    max_queued_requests: int = -1
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    #: Interval between controller-driven check_health() probes on RUNNING
    #: replicas (the first probe fires as soon as the replica is RUNNING).
    health_check_period_s: float = 10.0
    #: A probe outstanding longer than this counts as one failure.
    health_check_timeout_s: float = 30.0
    #: Consecutive probe failures before RUNNING -> UNHEALTHY (actor death
    #: short-circuits the threshold).
    health_check_failure_threshold: int = 3
    #: How long a DRAINING replica waits for its in-flight requests and
    #: streams to finish before prepare_for_shutdown returns.
    graceful_shutdown_wait_loop_s: float = 2.0
    #: Hard-kill deadline counted from when draining began.
    graceful_shutdown_timeout_s: float = 5.0
    #: During a rolling update, how many replicas below target the healthy
    #: count may drop; 0 = never lose capacity (surge-then-drain).
    max_unavailable: int = 0
    #: Options of each replica's actor: ``num_gpus`` (a GPU replica),
    #: ``num_cpus``, ``memory``, ``resources``, ``max_concurrency``.
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class HTTPOptions:
    """(ref: serve/config.py HTTPOptions)."""

    host: str = "127.0.0.1"
    port: int = 8000
