"""Public scheduling strategies (the counterpart of
``ray_tpu/util/scheduling_strategies.py``; ref:
python/ray/util/scheduling_strategies.py)."""

from ray_tpu_torch._private.scheduling import (
    DefaultStrategy,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadStrategy,
)

__all__ = [
    "DefaultStrategy", "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy", "PlacementGroupSchedulingStrategy",
    "SpreadStrategy",
]
