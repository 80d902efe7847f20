"""Collective nodes for compiled graphs (the counterpart of
``ray_tpu/dag/collective_node.py``; ref: python/ray/dag/collective_node.py
_CollectiveOperation:19, CollectiveOutputNode:133;
python/ray/experimental/collective/allreduce.py).

``allreduce.bind([n1, ..., nK])`` inserts an allreduce across K same-shaped
per-actor outputs and yields K nodes, one per participant, so each actor's
downstream ops see the reduced value.  In the reference this lowers to an
NCCL group call scheduled into each actor's op list; here, as in the JAX
package, the reduction runs on the channel fabric in a zero-resource reducer
actor (gather -> elementwise reduce -> fan out).  Leaves are torch tensors
(reduced on their own device), numpy arrays or numbers, in dicts, lists and
tuples.
"""

from __future__ import annotations

import operator
from typing import Callable, List

from ray_tpu_torch.dag.dag_node import ClassMethodNode, DAGNode


def _tree_binop(a, b, op: Callable):
    if isinstance(a, dict):
        return {k: _tree_binop(a[k], b[k], op) for k in a}
    if isinstance(a, (list, tuple)):
        out = [_tree_binop(x, y, op) for x, y in zip(a, b)]
        return out if isinstance(a, list) else tuple(out)
    return op(a, b)


def _elementwise(scalar: Callable, tensor: str) -> Callable:
    """``max``/``min`` of two leaves: elementwise for tensors and arrays."""

    def op(a, b):
        if hasattr(a, "shape"):
            import numpy as np

            if isinstance(a, np.ndarray):
                return getattr(np, tensor)(a, b)
            import torch

            return getattr(torch, tensor)(a, b)
        return scalar(a, b)

    return op


_OPS = {"sum": operator.add, "max": _elementwise(max, "maximum"),
        "min": _elementwise(min, "minimum")}


class _ReducerActor:
    """Gathers K shards, reduces, returns the result K times."""

    def reduce(self, *shards, _op: str = "sum"):
        binop = _OPS[_op]
        acc = shards[0]
        for s in shards[1:]:
            acc = _tree_binop(acc, s, binop)
        return acc


class AllReduceWrapper:
    """``from ray_tpu_torch.dag.collective_node import allreduce;
    allreduce.bind(nodes)``"""

    def bind(self, nodes: List[DAGNode], op: str = "sum") -> List[DAGNode]:
        if not nodes:
            raise ValueError("allreduce.bind requires at least one node")
        for n in nodes:
            if not isinstance(n, ClassMethodNode):
                raise ValueError("allreduce participants must be actor-method nodes")
        if op not in _OPS:
            raise ValueError(f"allreduce op must be one of {sorted(_OPS)}")
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class _Reducer(_ReducerActor):
            pass

        reducer = _Reducer.remote()
        reduced = ClassMethodNode(reducer, "reduce", tuple(nodes), {"_op": op})
        # K references to the one reduced node (mirrors CollectiveOutputNode's
        # K outputs): each participant's downstream binds it and gets its own
        # fan-out channel at compile time.
        return [reduced for _ in nodes]


allreduce = AllReduceWrapper()
