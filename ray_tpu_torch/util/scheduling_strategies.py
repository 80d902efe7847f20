"""Public scheduling strategies (the counterpart of
``ray_tpu/util/scheduling_strategies.py``; ref:
python/ray/util/scheduling_strategies.py).

The one-node runtime acts on ``PlacementGroupSchedulingStrategy``; the
node-choosing strategies (SPREAD, node affinity, node labels) come with the
multi-node runtime (ROADMAP.md, Queue 1 item 13.8).
"""

from ray_tpu_torch._private.scheduling import PlacementGroupSchedulingStrategy

__all__ = ["PlacementGroupSchedulingStrategy"]
