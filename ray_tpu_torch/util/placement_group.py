"""Placement groups (the counterpart of ``ray_tpu/util/placement_group.py``;
ref: python/ray/util/placement_group.py — PlacementGroup:41,
placement_group():145, strategies PACK / SPREAD / STRICT_PACK /
STRICT_SPREAD:162).

The scheduler reserves a group's bundles all at once or not at all, across
the cluster's nodes (``_private/scheduling.py``); ``bundle_node_ids()``
names the node each bundle landed on. A bundle's GPU share names its
cards, and a task or actor given ``PlacementGroupSchedulingStrategy``
leases from it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import ObjectID, PlacementGroupID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime import get_runtime
from ray_tpu_torch._private.scheduling import (  # noqa: F401 — re-export
    STRATEGIES as VALID_STRATEGIES,
    PlacementGroupSchedulingStrategy,
)


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID):
        self.id = pg_id

    def ready(self) -> ObjectRef:
        """An ObjectRef that resolves once every bundle is reserved (ref:
        pg.ready())."""
        runtime = get_runtime()
        state = runtime.scheduler.get_placement_group(self.id)
        ref_id = ObjectID(f"pgready-{self.id}:0")

        def waiter():
            state.ready_event.wait()
            runtime.store.put(ref_id, self)

        threading.Thread(target=waiter, daemon=True).start()
        return ObjectRef(ref_id, owner="driver")

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        state = get_runtime().scheduler.get_placement_group(self.id)
        if state is None:
            return False
        return state.ready_event.wait(timeout_seconds)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        state = get_runtime().scheduler.get_placement_group(self.id)
        return [dict(b.resources) for b in state.bundles]

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def bundle_node_ids(self) -> List[Optional[str]]:
        state = get_runtime().scheduler.get_placement_group(self.id)
        return [str(b.node_id) if b.node_id else None for b in state.bundles]

    def __reduce__(self):
        return (PlacementGroup, (self.id,))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    pg_id = PlacementGroupID.from_random()
    get_runtime().scheduler.create_placement_group(pg_id, bundles, strategy,
                                                   name)
    return PlacementGroup(pg_id)


def remove_placement_group(pg: PlacementGroup) -> None:
    get_runtime().scheduler.remove_placement_group(pg.id)


def get_current_placement_group() -> Optional[PlacementGroup]:
    return None  # as the reference: child-task capture is not modelled


def placement_group_table() -> Dict[str, dict]:
    out = {}
    for state in get_runtime().scheduler.placement_groups():
        out[str(state.id)] = {
            "name": state.name,
            "strategy": state.strategy,
            "state": state.state,
            "bundles": [dict(b.resources) for b in state.bundles],
        }
    return out
