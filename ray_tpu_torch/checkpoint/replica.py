"""In-memory peer replica tier (Gemini, SOSP '23 §4; the counterpart of
``ray_tpu/checkpoint/replica.py``).

The coordinator already pins each shard snapshot in the object store; the
piece that survives a *node* failure is the ``ReplicaHolder`` — an actor
scheduled onto a different node than the writers that materializes its
own copy of every registered shard payload.  Recovery then reads from
whichever tier is still alive instead of walking back to (slow, possibly
remote) checkpoint storage.

On a single-node cluster there is no peer to place the holder on;
``start_peer_holder`` returns None and the tier degrades to the object
store copy alone — still enough for worker-death (not node-death)
recovery.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class ReplicaHolder:
    """Holds materialized shard payloads: (step, shard_id) -> payload.

    Nothing pins this actor to a single-threaded mailbox (tests also use
    the class directly), so ``_shards`` is lock-protected; the (slow, up
    to 30s) payload materialization happens *before* taking the lock so a
    wedged fetch from a dying writer node can't stall every other call.
    """

    def __init__(self):
        self._shards: Dict[tuple, dict] = {}  # guarded_by: _lock
        self._lock = threading.Lock()

    def hold(self, step: int, shard_id: int, wrapped_ref: dict) -> None:
        import ray_tpu_torch

        # Materialize NOW: the point is a copy that outlives the writer's
        # node, not another pointer into its object store.  Bounded: if
        # the writer's node died between register and mirror, fail this
        # mirror (the coordinator tolerates it) instead of wedging the
        # holder's mailbox.
        payload = ray_tpu_torch.get(wrapped_ref["ref"], timeout=30)
        with self._lock:
            self._shards[(step, shard_id)] = payload

    def trim(self, keep_steps: List[int]) -> None:
        keep = set(keep_steps)
        with self._lock:
            for key in [k for k in self._shards if k[0] not in keep]:
                del self._shards[key]

    def fetch(self, step: int) -> Dict[int, dict]:
        """All held shard payloads for a step (possibly partial)."""
        with self._lock:
            return {sid: p for (s, sid), p in self._shards.items()
                    if s == step}

    def held(self) -> List[tuple]:
        with self._lock:
            return sorted(self._shards)


def _pick_peer_node() -> Optional[str]:
    """A live node other than this one (the head, where the coordinator
    runs), the one hosting the fewest live actors: a holder beside a train
    worker dies in the very preemption it exists to survive. None on a
    single-node cluster."""
    from ray_tpu_torch._private.runtime import get_runtime

    runtime = get_runtime()
    head = str(runtime.head_node_id)
    load: Dict[str, int] = {}
    for st in list(runtime._actors.values()):
        if st.state == "ALIVE" and st.node_id is not None:
            load[str(st.node_id)] = load.get(str(st.node_id), 0) + 1
    candidates = [str(n.id) for n in runtime.scheduler.nodes()
                  if n.alive and str(n.id) != head]
    if not candidates:
        return None
    return min(candidates, key=lambda nid: load.get(nid, 0))


def start_peer_holder():
    """Start a ReplicaHolder on a peer node (soft node affinity), or return
    None when the cluster has nowhere else to put it."""
    node_id = _pick_peer_node()
    if node_id is None:
        return None
    import ray_tpu_torch
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    return (ray_tpu_torch.remote(ReplicaHolder)
            .options(scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id, soft=True))
            .remote())
