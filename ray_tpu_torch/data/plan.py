"""Logical plan: operator DAG + optimizer rules (the counterpart of
``ray_tpu/data/plan.py``).

(ref: python/ray/data/_internal/logical/operators/ — Read, MapBatches, ...;
optimizer rules in _internal/logical/rules/ and optimizers.py; planner in
_internal/planner/planner.py).  A Dataset is a chain of logical ops; the
optimizer fuses adjacent per-block transforms into one task (operator fusion
— the single most important Data optimization: one object-store round trip
per block instead of one per op).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class LogicalOp:
    name: str = "op"

    def __init__(self, input_op: Optional["LogicalOp"] = None):
        self.input_op = input_op

    def chain(self) -> List["LogicalOp"]:
        ops: List[LogicalOp] = []
        op: Optional[LogicalOp] = self
        while op is not None:
            ops.append(op)
            op = op.input_op
        return list(reversed(ops))


class Read(LogicalOp):
    name = "Read"

    def __init__(self, read_tasks: List[Callable[[], Any]], schema_hint=None):
        super().__init__(None)
        self.read_tasks = read_tasks
        self.schema_hint = schema_hint


class InputData(LogicalOp):
    name = "InputData"

    def __init__(self, blocks: List[Any]):
        super().__init__(None)
        self.blocks = blocks


@dataclass
class ComputeStrategy:
    """TaskPool (default) vs ActorPool (stateful, e.g. model inference on
    GPU actors) (ref: task_pool_map_operator.py / actor_pool_map_operator.py)."""

    kind: str = "tasks"
    pool_size: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    #: Autoscaling ceiling for actor pools (ref: data/_internal/execution/
    #: autoscaler/ actor-pool autoscaling): the executor grows the pool from
    #: pool_size up to max_size while the op is backlogged.
    max_size: int = 1


class ActorPoolStrategy(ComputeStrategy):
    def __init__(self, size: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None,
                 min_size: int = 1, max_size: Optional[int] = None):
        if size is not None:
            min_size = max_size = size
        if min_size < 1:
            raise ValueError(f"min_size must be >= 1, got {min_size}")
        if max_size is not None and max_size < min_size:
            raise ValueError(
                f"max_size ({max_size}) must be >= min_size ({min_size})")
        super().__init__(kind="actors", pool_size=min_size,
                         resources=resources or {},
                         max_size=max(max_size or min_size, min_size))


class AbstractMap(LogicalOp):
    """Per-block transform: block -> block."""

    def __init__(self, input_op: LogicalOp, fn: Callable, compute: Optional[ComputeStrategy] = None,
                 fn_constructor: Optional[Callable] = None, name: str = "Map"):
        super().__init__(input_op)
        self.fn = fn
        self.compute = compute or ComputeStrategy()
        self.fn_constructor = fn_constructor
        self.name = name


class MapBatches(AbstractMap):
    def __init__(self, input_op, fn, batch_size: Optional[int] = None,
                 batch_format: str = "numpy", compute=None, fn_constructor=None):
        super().__init__(input_op, fn, compute, fn_constructor, name="MapBatches")
        self.batch_size = batch_size
        self.batch_format = batch_format


class MapRows(AbstractMap):
    def __init__(self, input_op, fn, compute=None):
        super().__init__(input_op, fn, compute, name="Map")


class Filter(AbstractMap):
    def __init__(self, input_op, fn, compute=None):
        super().__init__(input_op, fn, compute, name="Filter")


class FlatMap(AbstractMap):
    def __init__(self, input_op, fn, compute=None):
        super().__init__(input_op, fn, compute, name="FlatMap")


class Limit(LogicalOp):
    name = "Limit"

    def __init__(self, input_op, limit: int):
        super().__init__(input_op)
        self.limit = limit


class Repartition(LogicalOp):
    name = "Repartition"

    def __init__(self, input_op, num_blocks: int):
        super().__init__(input_op)
        self.num_blocks = num_blocks


class RandomShuffle(LogicalOp):
    name = "RandomShuffle"

    def __init__(self, input_op, seed: Optional[int] = None):
        super().__init__(input_op)
        self.seed = seed


class Sort(LogicalOp):
    name = "Sort"

    def __init__(self, input_op, key: str, descending: bool = False):
        super().__init__(input_op)
        self.key = key
        self.descending = descending


class Union(LogicalOp):
    name = "Union"

    def __init__(self, input_op, others: List[LogicalOp]):
        super().__init__(input_op)
        self.others = others


class Zip(LogicalOp):
    """Row-aligned column concat with another plan (ref: logical/operators/
    zip_operator.py).  The right side materializes at execution; the left
    streams through, keeping its block boundaries."""

    def __init__(self, input_op, other: LogicalOp):
        super().__init__(input_op)
        self.other = other


class Aggregate(LogicalOp):
    name = "Aggregate"

    def __init__(self, input_op, key: Optional[str], aggs: List[Any]):
        super().__init__(input_op)
        self.key = key
        #: mixed list of (column, fn-name) tuples and data.aggregate
        #: AggregateFn specs; the executor normalizes.
        self.aggs = aggs


class MapGroups(LogicalOp):
    """Apply a UDF per group (ref: grouped_data.py:93 map_groups — sorts by
    key, slices group boundaries, maps each group batch)."""

    name = "MapGroups"

    def __init__(self, input_op, key: Optional[str], fn, batch_format: str = "numpy"):
        super().__init__(input_op)
        self.key = key
        self.fn = fn
        self.batch_format = batch_format


def fuse_maps(ops: List[LogicalOp]) -> List[LogicalOp]:
    """Fuse adjacent task-pool maps (ref: rules/operator_fusion.py).

    Actor-pool maps are never fused into task maps (different executors), and
    MapBatches with different batch formats keep their own batching.
    """
    from ray_tpu_torch.data.executor import make_block_transform

    fused: List[LogicalOp] = []
    for op in ops:
        if (
            isinstance(op, AbstractMap)
            and fused
            and isinstance(fused[-1], AbstractMap)
            and fused[-1].compute.kind == "tasks"
            and op.compute.kind == "tasks"
            and fused[-1].fn_constructor is None
            and op.fn_constructor is None
        ):
            prev = fused.pop()
            f1 = make_block_transform(prev)
            f2 = make_block_transform(op)

            def composed(block, _f1=f1, _f2=f2):
                return _f2(_f1(block))

            merged = AbstractMap(prev.input_op, composed,
                                 name=f"{prev.name}->{op.name}")
            merged._pre_transformed = True
            fused.append(merged)
        else:
            fused.append(op)
    return fused
