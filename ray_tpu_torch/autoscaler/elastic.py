"""Elastic-capacity signals and the simulated-preemption hook (the
counterpart of ``ray_tpu/autoscaler/elastic.py``).

The elastic Trainer needs two things from the cluster layer:

* ``worker_capacity(bundle)`` — how many copies of a worker bundle the live
  cluster can host. The trainer shrinks its world to this after a
  preemption and grows back toward ``max_workers`` when it recovers
  (checked every ``ElasticConfig.grow_check_period_s``). Capacity counts
  each node's total resources, not what is free now: between attempts the
  worker group's placement group is released, and a decision made against
  resources it still holds would wait on the very group it replaces.
* ``simulate_preemption(...)`` — a node vanishing as a preempted one does:
  every actor it hosts dies (``ActorDiedError`` to anyone awaiting their
  calls) and the node leaves the cluster in the same stroke. Tests and
  ``chip_smoke.py`` call it, and the Trainer's ``preempt_node`` fault point
  (``_private/fault_injection.py``) does.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

logger = logging.getLogger(__name__)

Resources = Dict[str, float]


def _bundle_fits(total: Resources, bundle: Resources) -> int:
    """How many copies of ``bundle`` fit in ``total`` (0 when any key is
    missing)."""
    copies = None
    for key, need in bundle.items():
        if need <= 0:
            continue
        n = int(total.get(key, 0.0) / need + 1e-9)
        copies = n if copies is None else min(copies, n)
    return 0 if copies is None else copies


def worker_capacity(bundle: Resources,
                    exclude_nodes: Optional[set] = None) -> int:
    """Copies of ``bundle`` the live cluster can host, summed over alive
    nodes (against node totals — see the module docstring)."""
    from ray_tpu_torch._private.runtime import get_runtime

    exclude = {str(n) for n in (exclude_nodes or ())}
    return sum(_bundle_fits(node.total, bundle)
               for node in get_runtime().scheduler.nodes()
               if node.alive and str(node.id) not in exclude)


def capacity_available(bundle: Resources, want: int) -> bool:
    """True when the live cluster can host ``want`` copies of ``bundle``:
    the trainer's grow signal."""
    return worker_capacity(bundle) >= want


def actors_on_node(node_id) -> list:
    """ActorIDs of the live actors placed on ``node_id``."""
    from ray_tpu_torch._private.runtime import get_runtime

    want = str(node_id)
    return [aid for aid, state in list(get_runtime()._actors.items())
            if state.state == "ALIVE" and state.node_id is not None
            and str(state.node_id) == want]


def pick_preemptible_node(exclude_head: bool = True) -> Optional[str]:
    """A live node a preemption could take (never the head by default);
    None when there is none."""
    from ray_tpu_torch._private.runtime import get_runtime

    runtime = get_runtime()
    head = str(runtime.head_node_id)
    for node in runtime.scheduler.nodes():
        if node.alive and (not exclude_head or str(node.id) != head):
            return str(node.id)
    return None


def simulate_preemption(node_id: Optional[str] = None,
                        exclude_head: bool = True) -> Optional[str]:
    """Preempt one node: kill every actor it hosts (no restart: a preempted
    node does not come back as the same node), then take the node out of
    the cluster. Returns the node's id, or None when there is no candidate
    (a cluster of the head alone, with ``exclude_head``)."""
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.train import metrics as train_metrics

    runtime = get_runtime()
    if node_id is None:
        node_id = pick_preemptible_node(exclude_head=exclude_head)
        if node_id is None:
            return None
    victims = actors_on_node(node_id)
    for aid in victims:
        runtime.kill_actor(aid, no_restart=True)
    runtime.remove_node(node_id)
    train_metrics.PREEMPTIONS.inc()
    logger.warning("simulated preemption: node %s (%d actor(s) killed)",
                   node_id, len(victims))
    return str(node_id)
