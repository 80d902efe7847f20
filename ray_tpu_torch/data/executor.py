"""Streaming executor: runs the logical op chain over blocks with bounded
in-flight tasks (the counterpart of ``ray_tpu/data/executor.py``).

(ref: python/ray/data/_internal/execution/streaming_executor.py:48 and
streaming_executor_state.py — an operator-DAG scheduling loop under resource
budgets with backpressure; task-pool and actor-pool map operators in
execution/operators/).  Structure kept: per-op transforms become tasks (or
actor calls for stateful compute) on the core runtime; blocks stream through
with a bounded number outstanding (backpressure), and outputs are yielded as
they finish — iteration overlaps with execution.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block, BlockAccessor, block_from_batch, block_from_rows, concat_blocks
from ray_tpu_torch.data.plan import (
    AbstractMap,
    Aggregate,
    Filter,
    FlatMap,
    InputData,
    Limit,
    LogicalOp,
    MapBatches,
    MapGroups,
    MapRows,
    RandomShuffle,
    Read,
    Zip,
    Repartition,
    Sort,
    Union,
    fuse_maps,
)

#: Max map tasks in flight per operator (backpressure; ref:
#: backpressure_policy/concurrency_cap_backpressure_policy.py).
MAX_IN_FLIGHT = 8


class ResourceBudget:
    """Per-op in-flight budget: a task cap AND a bytes cap
    (ref: execution/resource_manager.py + backpressure_policy/ — operators
    may not hold more than their share of object-store memory in flight).

    Block sizes are learned from completed blocks (EMA), so the byte cap
    tightens as soon as real sizes are observed; until then the task cap
    alone applies.  The whole pipeline is pull-based, so a slow consumer
    stops new launches at the next cap check — memory stays bounded at
    cap * avg_block regardless of consumer speed."""

    def __init__(self, task_cap: int = MAX_IN_FLIGHT,
                 mem_fraction: float = 0.25,
                 mem_budget: Optional[int] = None):
        self._task_cap = max(1, task_cap)
        if mem_budget is not None:
            # Explicit byte budget (streaming ingest passes its window
            # budget) — skip the store-capacity heuristic entirely.
            self._mem_budget = max(1 << 20, int(mem_budget))
            self._avg_block = 0.0
            return
        store_cap = 0
        try:
            from ray_tpu_torch._private.runtime import runtime_or_none

            runtime = runtime_or_none()
            if runtime is not None:
                store_cap = runtime.store.capacity_bytes
        except Exception:
            pass
        if not store_cap:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            store_cap = GLOBAL_CONFIG.object_store_memory or (1 << 30)
        self._mem_budget = max(64 << 20, int(store_cap * mem_fraction))
        self._avg_block: float = 0.0

    def observe_ref(self, ref) -> None:
        """Learn block size from the store's recorded entry size — no
        driver-side get: fetching every block just to measure it would
        defeat the pass-by-reference stream (and restore spilled blocks)."""
        try:
            from ray_tpu_torch._private.runtime import runtime_or_none

            runtime = runtime_or_none()
            nbytes = runtime.store.size_of(ref.id) if runtime else 0
        except Exception:
            return
        if nbytes:
            self._observe_bytes(nbytes)

    def observe_block(self, block) -> None:
        try:
            nbytes = BlockAccessor(block).size_bytes()
        except Exception:
            return
        self._observe_bytes(nbytes)

    def _observe_bytes(self, nbytes: float) -> None:
        self._avg_block = (0.7 * self._avg_block + 0.3 * nbytes
                           if self._avg_block else float(nbytes))

    def cap(self) -> int:
        if self._avg_block > 0:
            by_mem = int(self._mem_budget // self._avg_block)
            return max(1, min(self._task_cap, by_mem))
        return self._task_cap


def make_block_transform(op: AbstractMap) -> Callable[[Block], Block]:
    """Build the pure block->block function for a map-family logical op."""
    if getattr(op, "_pre_transformed", False):
        return op.fn
    if isinstance(op, MapBatches):
        batch_size = op.batch_size
        batch_format = op.batch_format
        fn = op.fn

        def map_batches(block: Block) -> Block:
            acc = BlockAccessor(block)
            n = acc.num_rows()
            if n == 0:
                return block
            size = batch_size or n
            outs = []
            for start in range(0, n, size):
                piece = BlockAccessor(acc.slice(start, min(start + size, n)))
                out = fn(piece.to_batch(batch_format))
                outs.append(block_from_batch(out))
            return concat_blocks(outs)

        return map_batches
    if isinstance(op, Filter):
        fn = op.fn

        def filter_block(block: Block) -> Block:
            acc = BlockAccessor(block)
            keep = [i for i, row in enumerate(acc.iter_rows()) if fn(row)]
            return acc.take(keep) if len(keep) < acc.num_rows() else block

        return filter_block
    if isinstance(op, FlatMap):
        fn = op.fn

        def flat_map(block: Block) -> Block:
            rows = []
            for row in BlockAccessor(block).iter_rows():
                rows.extend(fn(row))
            return block_from_rows(rows)

        return flat_map
    if isinstance(op, MapRows):
        fn = op.fn

        def map_rows(block: Block) -> Block:
            return block_from_rows([fn(row) for row in BlockAccessor(block).iter_rows()])

        return map_rows
    if isinstance(op, AbstractMap):
        return op.fn
    raise TypeError(f"not a map op: {op}")


class _ActorPool:
    """Stateful map execution on a pool of actors (ref:
    actor_pool_map_operator.py — the GPU batch-inference path: actors hold
    the model, on the cards their leases name (``{"GPU": n}`` in the
    strategy's resources); blocks round-robin across them)."""

    def __init__(self, op: AbstractMap):
        transform = make_block_transform(op)
        fn_constructor = op.fn_constructor

        @ray_tpu_torch.remote
        class MapWorker:
            def __init__(self):
                self.state = fn_constructor() if fn_constructor is not None else None

            def apply(self, block, transform=transform):
                if self.state is not None:
                    return transform_with_state(block, self.state)
                return transform(block)

        def transform_with_state(block, state):
            # fn is (batch, state) when a constructor is given.
            acc = BlockAccessor(block)
            n = acc.num_rows()
            if n == 0:
                return block
            size = getattr(op, "batch_size", None) or n
            fmt = getattr(op, "batch_format", "numpy")
            outs = []
            for start in range(0, n, size):
                piece = BlockAccessor(acc.slice(start, min(start + size, n)))
                outs.append(block_from_batch(op.fn(piece.to_batch(fmt), state)))
            return concat_blocks(outs)

        res = dict(op.compute.resources)
        self._actor_req = dict(res) if res else {"CPU": 1.0}
        self._mk_actor = lambda: MapWorker.options(
            resources=res or None, num_cpus=None if res else 1).remote()
        self.max_size = max(op.compute.max_size, op.compute.pool_size)
        self.actors = [self._mk_actor() for _ in range(op.compute.pool_size)]
        self._rr = 0

    def size(self) -> int:
        return len(self.actors)

    def maybe_scale_up(self) -> bool:
        if len(self.actors) >= self.max_size:
            return False
        # One scale-up in flight at a time: actor leases are acquired
        # asynchronously, so available_resources() does not yet reflect an
        # actor we just appended — stacking scale-ups on that stale reading
        # could take the last CPU anyway.
        from ray_tpu_torch._private.runtime import get_runtime

        runtime = get_runtime()
        for a in self.actors:
            state = runtime.get_actor_state(a._ray_actor_id)
            if state is not None and state.state == "PENDING_CREATION":
                return False
        # Never scale into the last CPU: actors hold their lease for life,
        # and a pool that absorbs every slot starves the upstream read/map
        # TASKS forever — deadlock by oversubscription (ref:
        # resource_manager.py reserves budgets per operator).
        avail = ray_tpu_torch.available_resources()
        for key, need in self._actor_req.items():
            headroom = 1.0 if key == "CPU" else 0.0
            if avail.get(key, 0.0) < need + headroom:
                return False
        self.actors.append(self._mk_actor())
        return True

    def submit(self, block_ref):
        actor = self.actors[self._rr % len(self.actors)]
        self._rr += 1
        return actor.apply.remote(block_ref)

    def shutdown(self):
        for a in self.actors:
            ray_tpu_torch.kill(a)


def execute(op: LogicalOp) -> Iterator[Any]:
    """Yield block ObjectRefs for the plan rooted at `op`, streaming."""
    ops = fuse_maps(op.chain())
    stream: Iterator[Any] = _source_stream(ops[0])
    for logical in ops[1:]:
        stream = _apply_op(stream, logical)
    return stream


def _source_stream(src: LogicalOp) -> Iterator[Any]:
    if isinstance(src, InputData):
        for b in src.blocks:
            yield b if isinstance(b, ray_tpu_torch.ObjectRef) else ray_tpu_torch.put(b)
        return
    if isinstance(src, Read):
        @ray_tpu_torch.remote
        def do_read(task):
            return task()

        pending: List[Any] = []
        tasks = list(src.read_tasks)
        i = 0
        while i < len(tasks) or pending:
            while i < len(tasks) and len(pending) < MAX_IN_FLIGHT:
                pending.append(do_read.remote(tasks[i]))
                i += 1
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=10.0)
            for r in ready:
                yield r
        return
    raise TypeError(f"Unknown source op: {src}")


def _apply_op(stream: Iterator[Any], op: LogicalOp) -> Iterator[Any]:
    if isinstance(op, AbstractMap):
        if op.compute.kind == "actors":
            return _map_stream_actors(stream, op)
        return _map_stream_tasks(stream, op)
    if isinstance(op, Limit):
        return _limit_stream(stream, op.limit)
    if isinstance(op, (Repartition, RandomShuffle, Sort, Aggregate, MapGroups)):
        return _all_to_all(stream, op)
    if isinstance(op, Union):
        def union_stream():
            yield from stream
            for other in op.others:
                yield from execute(other)

        return union_stream()
    if isinstance(op, Zip):
        return _zip_stream(stream, op)
    raise TypeError(f"Unknown op: {op}")


def _unique_column_name(name: str, taken) -> str:
    if name not in taken:
        return name
    i = 1
    while f"{name}_{i}" in taken:
        i += 1
    return f"{name}_{i}"


def _zip_stream(stream: Iterator[Any], op: "Zip") -> Iterator[Any]:
    """Materialize the right side, slice it along the left's block
    boundaries (runs at consumption time — the plan stays lazy)."""
    right = concat_blocks([ray_tpu_torch.get(r) for r in execute(op.other)])
    offset = 0
    for ref in stream:
        left = ray_tpu_torch.get(ref)
        n = left.num_rows
        if offset + n > right.num_rows:
            raise ValueError(
                f"zip requires equal row counts; right side has only "
                f"{right.num_rows} rows")
        rslice = BlockAccessor(right).slice(offset, offset + n)
        offset += n
        taken = set(left.column_names)
        combined = {name: left.column(name) for name in left.column_names}
        for name in rslice.column_names:
            out = _unique_column_name(name, taken)
            taken.add(out)
            combined[out] = rslice.column(name)
        yield ray_tpu_torch.put(Block(combined))
    if offset != right.num_rows:
        raise ValueError(
            f"zip requires equal row counts: left has {offset}, right has "
            f"{right.num_rows}")


def _map_stream_tasks(stream: Iterator[Any], op: AbstractMap) -> Iterator[Any]:
    transform = make_block_transform(op)

    @ray_tpu_torch.remote
    def apply(block):
        return transform(block)

    budget = ResourceBudget()
    pending: List[Any] = []
    done = False
    while not done or pending:
        while not done and len(pending) < budget.cap():
            try:
                block_ref = next(stream)
            except StopIteration:
                done = True
                break
            pending.append(apply.remote(block_ref))
        if pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=30.0)
            for r in ready:
                budget.observe_ref(r)
                yield r


def _map_stream_actors(stream: Iterator[Any], op: AbstractMap) -> Iterator[Any]:
    pool = _ActorPool(op)
    budget = ResourceBudget(task_cap=max(MAX_IN_FLIGHT, op.compute.max_size))
    try:
        pending: List[Any] = []
        done = False
        while not done or pending:
            cap = min(budget.cap(), 2 * pool.size())
            while not done and len(pending) < cap:
                try:
                    block_ref = next(stream)
                except StopIteration:
                    done = True
                    break
                pending.append(pool.submit(block_ref))
            if not done and pending and len(pending) >= cap:
                # Backlogged at current capacity: autoscale up to max_size
                # (ref: actor-pool autoscaling in data/_internal/execution/
                # autoscaler/).
                pool.maybe_scale_up()
            if pending:
                ready, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=60.0)
                for r in ready:
                    budget.observe_ref(r)
                    yield r
    finally:
        pool.shutdown()


def _limit_stream(stream: Iterator[Any], limit: int) -> Iterator[Any]:
    seen = 0
    for ref in stream:
        if seen >= limit:
            return
        block = ray_tpu_torch.get(ref)
        n = BlockAccessor(block).num_rows()
        if seen + n <= limit:
            seen += n
            yield ref
        else:
            yield ray_tpu_torch.put(BlockAccessor(block).slice(0, limit - seen))
            seen = limit
            return


def _all_to_all(stream: Iterator[Any], op: LogicalOp) -> Iterator[Any]:
    """Exchange ops as DISTRIBUTED TASK STAGES (ref: planner/exchange/
    push_based_shuffle_task_scheduler.py): map tasks partition each block
    (hash/range/random), reduce tasks merge per partition.  The driver
    touches only refs and sample/count metadata — never the block data
    (the r2 driver-side concat_blocks of the whole dataset is gone)."""
    from ray_tpu_torch.data import exchange

    refs = list(stream)
    if not refs:
        return
    if isinstance(op, Sort):
        yield from exchange.sorted_exchange(refs, op.key, op.descending)
        return
    if isinstance(op, RandomShuffle):
        yield from exchange.shuffle_exchange(refs, op.seed)
        return
    if isinstance(op, Repartition):
        yield from exchange.repartition_exchange(refs, op.num_blocks)
        return
    if isinstance(op, Aggregate):
        if op.key is None:
            yield ray_tpu_torch.put(exchange.global_aggregate(refs, op))
        else:
            yield from exchange.hash_exchange(refs, op, "aggregate")
        return
    if isinstance(op, MapGroups):
        if op.key is None:
            # Keyless map_groups = ONE group by definition, so the UDF must
            # see the whole dataset in one task — exactly the reference's
            # behavior (grouped_data.py:188 repartition(1) when key is
            # None; its docstring warns each group must fit one node).
            # Per-group distribution applies only with a key (hash path).
            yield exchange._reduce_map_groups.remote(op, *refs)
        else:
            yield from exchange.hash_exchange(refs, op, "map_groups")
        return
    raise TypeError(op)


def _normalize_agg(agg) -> tuple:
    """(col, fn, spec) from a legacy tuple or an AggregateFn instance."""
    from ray_tpu_torch.data.aggregate import AggregateFn

    if isinstance(agg, AggregateFn):
        return agg.on if agg.on is not None else "*", agg.fn_name, agg
    col, fn = agg
    return col, fn, None


def _aggregate(block: Block, op: Aggregate) -> Block:
    acc = BlockAccessor(block)
    if op.key is None:
        row: Dict[str, Any] = {}
        for agg in op.aggs:
            col, fn, spec = _normalize_agg(agg)
            name = spec.output_name if spec is not None else f"{fn}({col})"
            if col == "*" or fn == "count":  # row/value count
                row[name] = acc.num_rows() if col == "*" \
                    else len(block_mod.column_to_numpy(block, col))
                continue
            vals = block_mod.column_to_numpy(block, col)
            row[name] = _agg_fn(fn, spec)(vals)
        return block_from_rows([row])
    if any(_normalize_agg(a)[1] in ("quantile", "unique") for a in op.aggs):
        # No streaming kernel for these: sort by key and reduce each group
        # slice (ref: the reference's sort-based per-group path —
        # push_based_shuffle + SortAggregate).  Exactness holds because the
        # hash exchange lands ALL rows of a key in one partition before this
        # runs.
        return _aggregate_sorted(block, op)
    return _aggregate_hash(block, op)


def _group_ids(keys: np.ndarray):
    """Group id per row, groups numbered by first appearance (the order of
    the reference's Arrow hash group-by); every NaN key is one group.
    Returns (ids, the row of each group's first appearance)."""
    keys = np.asarray(keys)
    if keys.dtype != object:
        _, first, inverse = np.unique(keys, return_index=True,
                                      return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        return rank[inverse.ravel()], first[order]
    ids = np.empty(len(keys), dtype=np.int64)
    seen: Dict[Any, int] = {}
    firsts: List[int] = []
    for i, k in enumerate(keys):
        key = _NAN_KEY if isinstance(k, float) and k != k else k
        g = seen.get(key)
        if g is None:
            g = seen[key] = len(firsts)
            firsts.append(i)
        ids[i] = g
    return ids, np.asarray(firsts, dtype=np.int64)


_NAN_KEY = object()


def _aggregate_hash(block: Block, op: Aggregate) -> Block:
    """Per-group sum/min/max/mean/count/std with the reference's Arrow
    group-by semantics: key column first, groups by first appearance,
    outputs named ``<col>_<kernel>`` (or the spec's alias), values
    accumulated in row order, missing values (NaN) skipped, a std with
    too few values NaN."""
    keys = block_mod.column_to_numpy(block, op.key)
    gid, first = _group_ids(keys)
    n_groups = len(first)
    out: Dict[str, np.ndarray] = {op.key: keys[first]}
    for agg in op.aggs:
        col, fn, spec = _normalize_agg(agg)
        if col == "*":
            col, fn = op.key, "count"
        if spec is not None and spec.alias_name:
            name = spec.alias_name
        else:
            name = f"{col}_{ {'std': 'stddev'}.get(fn, fn)}"
        if fn not in ("sum", "min", "max", "mean", "count", "std"):
            raise ValueError(f"unknown aggregation {fn!r}")
        out[name] = _group_reduce(block_mod.column_to_numpy(block, col), gid,
                                  n_groups, fn, getattr(spec, "ddof", 1))
    return Block(out)


def _group_reduce(vals: np.ndarray, gid: np.ndarray, n_groups: int, fn: str,
                  ddof: int) -> np.ndarray:
    vals = np.asarray(vals)
    valid = ~np.isnan(vals) if vals.dtype.kind == "f" else \
        np.asarray([v is not None for v in vals], dtype=bool) \
        if vals.dtype == object else np.ones(len(vals), dtype=bool)
    g, v = gid[valid], vals[valid]
    count = np.bincount(g, minlength=n_groups)
    if fn == "count":
        return count.astype(np.int64)
    if vals.dtype == object or fn in ("min", "max"):
        best: List[Any] = [None] * n_groups
        if fn in ("min", "max"):
            pick = min if fn == "min" else max
            for gi, x in zip(g.tolist(), v.tolist()):
                best[gi] = x if best[gi] is None else pick(best[gi], x)
            if vals.dtype != object and all(b is not None for b in best):
                return np.asarray(best, dtype=vals.dtype)
            return block_mod._to_column(best)
        raise ValueError(f"{fn} of a non-numeric column")
    if vals.dtype.kind in "iub" and fn == "sum":
        total = np.zeros(n_groups, dtype=np.int64)
        np.add.at(total, g, v.astype(np.int64))
        return total
    # bincount adds each group's values one at a time in row order.
    total = np.bincount(g, weights=v.astype(np.float64), minlength=n_groups)
    if fn == "sum":
        return total
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = total / count
        if fn == "mean":
            return mean
        dev = v.astype(np.float64) - mean[g]
        m2 = np.bincount(g, weights=dev * dev, minlength=n_groups)
        var = np.where(count > ddof, m2 / np.maximum(count - ddof, 1), np.nan)
    return np.sqrt(var)


def _aggregate_sorted(block: Block, op: Aggregate) -> Block:
    """Per-group aggregation by sort + boundary slicing: supports every
    agg fn including the order-statistics ones the hash path lacks
    (quantile, unique)."""
    order = np.argsort(block_mod.column_to_numpy(block, op.key),
                       kind="stable")
    tbl = BlockAccessor(block).take(order)
    keys = block_mod.column_to_numpy(tbl, op.key)
    n = len(keys)
    if n == 0:
        return block_from_rows([])
    changed = keys[1:] != keys[:-1]
    if np.issubdtype(np.asarray(keys).dtype, np.floating):
        # NaN != NaN would split the null group into one row per NaN;
        # adjacent NaNs (sorted together) are ONE group, as in the hash path.
        both_nan = np.isnan(keys[1:]) & np.isnan(keys[:-1])
        changed = changed & ~both_nan
    boundaries = [0] + [i + 1 for i in np.nonzero(changed)[0]] + [n]
    cols: Dict[str, np.ndarray] = {}
    rows: List[Dict[str, Any]] = []
    for gi in range(len(boundaries) - 1):
        start, end = boundaries[gi], boundaries[gi + 1]
        row: Dict[str, Any] = {op.key: keys[start]}
        for agg in op.aggs:
            col, fn, spec = _normalize_agg(agg)
            if col == "*":
                col, fn = op.key, "count"
            if spec is not None and spec.alias_name:
                name = spec.alias_name
            else:
                # Match the hash path's "<col>_<kernel>" naming.
                kernel = {"std": "stddev"}.get(fn, fn)
                name = f"{col}_{kernel}"
            if col not in cols:
                cols[col] = block_mod.column_to_numpy(tbl, col)
            vals = cols[col][start:end]
            if fn == "count":
                # Count only VALID values (missing values in float
                # columns are NaN), as the hash path does.
                v = np.asarray(vals)
                row[name] = (int(np.sum(~np.isnan(v)))
                             if np.issubdtype(v.dtype, np.floating)
                             else len(v))
            else:
                row[name] = _agg_fn(fn, spec)(vals)
        rows.append(row)
    return block_from_rows(rows)


def _agg_fn(name: str, spec=None):
    if name == "std":
        ddof = getattr(spec, "ddof", 1)
        return lambda v: np.std(v, ddof=ddof)
    if name == "quantile":
        q = getattr(spec, "q", 0.5)
        return lambda v: np.quantile(v, q)
    if name == "unique":
        return lambda v: sorted(set(np.asarray(v).tolist()))
    return {"sum": np.sum, "min": np.min, "max": np.max, "mean": np.mean,
            "count": len}[name]


def _map_groups(block: Block, op: MapGroups) -> Block:
    """Sort by key, slice group boundaries, apply the UDF per group batch,
    concat results (ref: grouped_data.py:93 map_groups)."""
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return block
    if op.key is None:
        groups = [block]
    else:
        keys = block_mod.column_to_numpy(block, op.key)
        order = np.argsort(keys, kind="stable")
        sorted_block = acc.take(list(map(int, order)))
        sorted_keys = keys[order]
        boundaries = [0] + [
            i for i in range(1, n) if sorted_keys[i] != sorted_keys[i - 1]
        ] + [n]
        sacc = BlockAccessor(sorted_block)
        groups = [sacc.slice(boundaries[i], boundaries[i + 1])
                  for i in range(len(boundaries) - 1)]
    out_blocks = []
    for g in groups:
        batch = BlockAccessor(g).to_batch(op.batch_format)
        result = op.fn(batch)
        out_blocks.append(block_from_batch(result))
    return concat_blocks(out_blocks)
