"""Multi-node cluster harness (the counterpart of ``ray_tpu/cluster_utils.py``
in its virtual mode; ref: python/ray/cluster_utils.py — Cluster:135,
add_node:202, remove_node:286).

Nodes are scheduler entries: placement across them (spread, affinity,
labels, placement groups) is real, while execution stays in this process,
the single-host multi-node setup the reference's tests are built on. A
node's GPUs are a share of one of the host's cards (``gpu_index``), so on a
one-card host several nodes can each hold a GPU rank, and the leases of
every node on card 0 name ``cuda:0``. ``real=True`` (each node its own
process joined over the network) is not ported yet (ROADMAP.md, Queue 1
item 13.8b).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.runtime import get_runtime


class Cluster:
    def __init__(self, initialize_head: bool = False,
                 head_node_args: Optional[dict] = None,
                 real: bool = False):
        if real:
            raise NotImplementedError(
                "Cluster(real=True) needs real worker nodes, which are not "
                "ported yet (ROADMAP.md, Queue 1 item 13.8b)")
        self.real = False
        self.head_node_id: Optional[NodeID] = None
        self._nodes: Dict[NodeID, dict] = {}
        if initialize_head:
            args = dict(head_node_args or {})
            runtime = ray_tpu_torch.init(ignore_reinit_error=True, **args)
            self.head_node_id = runtime.head_node_id
            self._nodes[self.head_node_id] = args

    def add_node(self, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 wait: bool = True, gpu_index: int = 0) -> NodeID:
        """A virtual node of ``num_cpus`` CPUs and ``num_gpus`` GPUs: a
        fraction of card ``gpu_index``, or that many whole cards from it.
        Raises for a card the host does not have."""
        node_resources = {"CPU": float(num_cpus)}
        cards = None
        if num_gpus:
            from ray_tpu_torch._private.device import gpu_count

            whole = num_gpus >= 1
            if whole and num_gpus != int(num_gpus):
                raise ValueError(
                    f"num_gpus={num_gpus}: more than one GPU must be whole")
            ids = range(gpu_index, gpu_index + (int(num_gpus) if whole else 1))
            have = gpu_count()
            if gpu_index < 0 or ids[-1] >= have:
                raise ValueError(
                    f"cards {list(ids)} asked for, and the host has {have}")
            cards = {i: 1.0 if whole else float(num_gpus) for i in ids}
            node_resources["GPU"] = float(num_gpus)
        node_resources.update(resources or {})
        node_id = get_runtime().scheduler.add_node(node_resources, labels,
                                                   gpu_cards=cards)
        self._nodes[node_id] = node_resources
        return node_id

    def wait_for_node(self, node_id: NodeID, timeout: float = 60.0) -> None:
        """Block until the node is registered with the scheduler (a virtual
        node is, once ``add_node`` returns)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            node = get_runtime().scheduler.get_node(node_id)
            if node is not None and node.alive:
                return
            time.sleep(0.05)
        raise TimeoutError(f"node {node_id} did not join within {timeout}s")

    def remove_node(self, node_id: NodeID, allow_graceful: bool = True) -> None:
        """Take the node out as its loss would (``Runtime.remove_node``)."""
        get_runtime().remove_node(node_id)
        self._nodes.pop(node_id, None)

    def shutdown(self) -> None:
        ray_tpu_torch.shutdown()
        self._nodes.clear()
