"""ray_tpu_torch.air — shared Train/Tune plumbing (ref: python/ray/air/).

The reference's `ray.air` is the common layer both libraries import:
configs (`air/config.py`), the session facade (`air/session.py`), and the
`integrations/` logger adapters.  Here the configs live in
`ray_tpu_torch.train.config` and the session in `ray_tpu_torch.train.session`; this
package re-exports them under the air names and hosts the integrations.

The counterpart of ``ray_tpu/air/__init__.py``.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import get_checkpoint, get_context, report

__all__ = [
    "Checkpoint", "CheckpointConfig", "FailureConfig", "RunConfig",
    "ScalingConfig", "get_checkpoint", "get_context", "report", "session",
]


class session:  # noqa: N801 — namespace mirror of ray.air.session
    """`ray.air.session` compatibility facade (ref: air/session.py)."""

    report = staticmethod(report)
    get_checkpoint = staticmethod(get_checkpoint)
    get_context = staticmethod(get_context)
