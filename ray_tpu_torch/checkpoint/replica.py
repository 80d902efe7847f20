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
recovery. The port's runtime is one node: the peer case waits for its
virtual nodes and node affinity (ROADMAP.md, Queue 1 item 13.8a).
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
    """A live node other than this one (head, where the coordinator runs),
    or None. The port's runtime lists one node, so this is None."""
    from ray_tpu_torch._private.runtime import get_runtime

    runtime = get_runtime()
    head = str(runtime.head_node_id)
    others = [str(n["NodeID"]) for n in runtime.nodes()
              if n.get("Alive") and str(n["NodeID"]) != head]
    return others[0] if others else None


def start_peer_holder():
    """Start a ReplicaHolder on a peer node, or return None when the
    cluster has nowhere else to put it."""
    node_id = _pick_peer_node()
    if node_id is None:
        return None
    raise NotImplementedError(
        f"placing the replica holder on node {node_id} needs node affinity "
        "(ROADMAP.md, Queue 1 item 13.8a)")
