"""Serve data-plane exceptions (the counterpart of
``ray_tpu/serve/exceptions.py``).

(ref: python/ray/serve/exceptions.py — BackPressureError raised when a
handle's ``max_queued_requests`` is exceeded; surfaced as HTTP 503 at the
proxy so overload degrades by shedding instead of by collapsing latency.)
"""

from __future__ import annotations

from ray_tpu_torch.exceptions import RayTpuError


class BackPressureError(RayTpuError):
    """The deployment is at capacity.

    Raised by the router when every replica's ``max_ongoing_requests``
    slots are in use and the deployment's ``max_queued_requests``
    allowance (when configured >= 0) is exhausted.  The HTTP proxy maps
    this to ``503 Service Unavailable`` with a ``Retry-After`` header.
    """

    def __init__(self, deployment_id: str = "", num_inflight: int = 0,
                 capacity: int = 0, max_queued_requests: int = 0,
                 retry_after_s: float = 1.0):
        self.deployment_id = deployment_id
        self.num_inflight = num_inflight
        self.capacity = capacity
        self.max_queued_requests = max_queued_requests
        self.retry_after_s = retry_after_s
        super().__init__(
            f"Deployment {deployment_id!r} is at capacity: {num_inflight} "
            f"in-flight >= {capacity} replica slots + {max_queued_requests} "
            f"queued allowance. Retry after ~{retry_after_s:.0f}s.")

    def __reduce__(self):
        # Same rationale as TaskError.__reduce__: reconstruct from fields,
        # not from the formatted message, so the error survives pickling
        # across the actor boundary.
        return (BackPressureError,
                (self.deployment_id, self.num_inflight, self.capacity,
                 self.max_queued_requests, self.retry_after_s))
