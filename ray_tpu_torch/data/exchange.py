"""Distributed data exchange: shuffle/sort/groupby as SCHEDULED TASKS
(the counterpart of ``ray_tpu/data/exchange.py``).

An analogue of the reference's push-based shuffle (ref:
python/ray/data/_internal/planner/exchange/push_based_shuffle_task_scheduler.py
and sort_task_spec.py): a MAP stage partitions every input block into P
partition blocks (hash of the key, range against sampled boundaries, or
random), and a REDUCE stage merges/sorts/aggregates each partition — all as
tasks over the object store, so block data never concatenates on the
driver.  The driver holds only ObjectRefs and the tiny sample/count
metadata; any dataset that fits the cluster's stores (not the driver heap)
exchanges fine, and on worker-node clusters partition blocks move node-to-
node over the object plane.

Global (key-less) aggregations reduce per-block PARTIAL STATES (sum/count/
min/max/M2) combined on the driver — one small dict per block.  quantile/
unique have no bounded partial: they gather the single COLUMN (documented:
bounded by column bytes, not dataset bytes).
"""

from __future__ import annotations

from typing import Any, Iterator, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.block import Block, BlockAccessor, block_from_rows, concat_blocks

#: Cap on reduce partitions (P) — below it, P tracks the input block count.
#: Default; the live value comes from the config flag so operators can
#: raise it for wide clusters (RAY_TPU_DATA_MAX_PARTITIONS).
MAX_PARTITIONS = 32
#: Map/reduce tasks in flight (same backpressure role as executor.MAX_IN_FLIGHT).
MAX_IN_FLIGHT = 8


def _num_partitions(n_blocks: int) -> int:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    cap = getattr(GLOBAL_CONFIG, "data_max_partitions", MAX_PARTITIONS)
    return max(1, min(n_blocks, cap))


# ----------------------------------------------------------------- map tasks
@ray_tpu_torch.remote
def _sample_keys(blk: Block, key: str, k: int):
    vals = block_mod.column_to_numpy(blk, key)
    if len(vals) <= k:
        return np.asarray(vals)
    idx = np.linspace(0, len(vals) - 1, k).astype(np.int64)
    return np.asarray(vals)[idx]


@ray_tpu_torch.remote
def _count_rows(blk: Block) -> int:
    return BlockAccessor(blk).num_rows()


def _take(acc: BlockAccessor, idx) -> Block:
    return acc.take(idx)


def _partition_hash(blk: Block, key: str, p: int):
    """Bucket rows by a hash that is STABLE ACROSS PROCESSES (python's str
    hash is randomized per interpreter; map tasks may run on different
    nodes, and all rows of one key must land in one partition)."""
    acc = BlockAccessor(blk)
    vals = np.asarray(block_mod.column_to_numpy(blk, key))
    if vals.dtype.kind in "iub":
        buckets = (vals.astype(np.int64) % p + p) % p
    elif vals.dtype.kind == "f":
        # hash() of numeric values is NOT randomized — stable everywhere —
        # EXCEPT NaN, whose hash is id-based since 3.10: pin all NaNs to
        # bucket 0 so they stay one group across processes.
        buckets = np.asarray([0 if v != v else abs(hash(float(v))) % p
                              for v in vals])
    else:
        buckets = np.asarray(
            [int.from_bytes(str(v).encode()[-8:].rjust(8, b"\0"), "little") % p
             for v in vals])
    return [_take(acc, np.nonzero(buckets == i)[0]) for i in range(p)]


def _partition_range(blk: Block, key: str, bounds: np.ndarray):
    acc = BlockAccessor(blk)
    vals = block_mod.column_to_numpy(blk, key)
    buckets = np.searchsorted(bounds, vals, side="right")
    return [_take(acc, np.nonzero(buckets == i)[0])
            for i in range(len(bounds) + 1)]


def _partition_random(blk: Block, p: int, seed):
    acc = BlockAccessor(blk)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, p, n)
    return [_take(acc, np.nonzero(buckets == i)[0]) for i in range(p)]


# -------------------------------------------------------------- reduce tasks
def _merge(parts) -> Block:
    nonempty = [b for b in parts if BlockAccessor(b).num_rows() > 0]
    if nonempty:
        return concat_blocks(nonempty)
    # All-empty partition: keep a SCHEMA-BEARING empty block (concat_blocks
    # of nothing degrades to a column-less block, which has no key).
    return parts[0]


def _sort_indices(vals: np.ndarray, descending: bool) -> np.ndarray:
    """Stable sort order of ``vals`` (ties keep their order), NaNs last in
    either direction: the order of the reference's Arrow ``sort_indices``."""
    vals = np.asarray(vals)
    nan = np.isnan(vals) if vals.dtype.kind == "f" else \
        np.zeros(len(vals), dtype=bool)
    idx = np.nonzero(~nan)[0]
    sub = vals[idx]
    if descending:
        order = len(sub) - 1 - np.argsort(sub[::-1], kind="stable")[::-1]
    else:
        order = np.argsort(sub, kind="stable")
    return np.concatenate([idx[order], np.nonzero(nan)[0]])


@ray_tpu_torch.remote
def _reduce_sort(key: str, descending: bool, *parts) -> Block:
    combined = _merge(parts)
    idx = _sort_indices(block_mod.column_to_numpy(combined, key), descending)
    return BlockAccessor(combined).take(idx)


@ray_tpu_torch.remote
def _reduce_shuffle(seed, *parts) -> Block:
    combined = _merge(parts)
    n = BlockAccessor(combined).num_rows()
    rng = np.random.default_rng(seed)
    return BlockAccessor(combined).take(list(map(int, rng.permutation(n))))


@ray_tpu_torch.remote
def _reduce_concat(*parts) -> Block:
    return _merge(parts)


@ray_tpu_torch.remote
def _reduce_aggregate(op, *parts) -> Block:
    from ray_tpu_torch.data.executor import _aggregate

    return _aggregate(_merge(parts), op)


@ray_tpu_torch.remote
def _reduce_map_groups(op, *parts) -> Block:
    from ray_tpu_torch.data.executor import _map_groups

    return _map_groups(_merge(parts), op)


@ray_tpu_torch.remote
def _slice_block(blk: Block, start: int, stop: int) -> Block:
    return BlockAccessor(blk).slice(start, stop)


# ------------------------------------------------------------- orchestration
def _bounded(tasks: List[Any]) -> Iterator[Any]:
    """Drain already-submitted reduce tasks in completion order."""
    pending = list(tasks)
    while pending:
        ready, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=60.0)
        yield from ready


@ray_tpu_torch.remote
def _partition_range_task(blk, key, bounds):
    return tuple(_partition_range(blk, key, bounds))


@ray_tpu_torch.remote
def _partition_hash_task(blk, key, p):
    return tuple(_partition_hash(blk, key, p))


@ray_tpu_torch.remote
def _partition_random_task(blk, p, sub):
    return tuple(_partition_random(blk, p, sub))


def _map_partitions(refs: List[Any], task_fn, p: int,
                    args_for) -> List[List[Any]]:
    """Run the map stage with bounded in-flight tasks; returns
    per-partition lists of partition-block refs (transposed).
    ``args_for(i)`` supplies the extra task args for input block i (one
    shared remote function — no per-block closures to pickle).  p == 1
    passes blocks through unsplit (a single partition IS the block)."""
    out: List[List[Any]] = [[] for _ in range(p)]
    if p == 1:
        out[0] = list(refs)
        return out
    pending = []
    for i, r in enumerate(refs):
        res = task_fn.options(num_returns=p).remote(r, *args_for(i))
        for j in range(p):
            out[j].append(res[j])
        pending.append(res[0])
        while len(pending) >= MAX_IN_FLIGHT:
            _, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=60.0)
    return out


def sorted_exchange(refs: List[Any], key: str, descending: bool) -> Iterator[Any]:
    """Sample -> range-partition -> per-partition sort (ref:
    sort_task_spec.py SortTaskSpec.sample_boundaries)."""
    p = _num_partitions(len(refs))
    samples = ray_tpu_torch.get([_sample_keys.remote(r, key, 32) for r in refs])
    allsamp = np.sort(np.concatenate([np.asarray(s) for s in samples]))
    if p > 1 and len(allsamp):
        idx = (np.arange(1, p) * len(allsamp)) // p
        bounds = allsamp[idx]
    else:
        bounds = np.asarray([])

    parts = _map_partitions(refs, _partition_range_task, len(bounds) + 1,
                            lambda i: (key, bounds))
    reducers = [_reduce_sort.remote(key, descending, *pp) for pp in parts]
    if descending:
        reducers = list(reversed(reducers))
    # Yield IN PARTITION ORDER: output blocks are globally sorted.
    yield from reducers


def shuffle_exchange(refs: List[Any], seed) -> Iterator[Any]:
    p = _num_partitions(len(refs))
    # Distinct per-block sub-seeds, fixed at submission time: a seeded
    # shuffle is deterministic regardless of task placement.
    parts = _map_partitions(
        refs, _partition_random_task, p,
        lambda i: (p, None if seed is None else seed + i * 7919))
    reducers = [
        _reduce_shuffle.remote(None if seed is None else seed + 104729 + j, *pp)
        for j, pp in enumerate(parts)]
    # Partition order, not completion order: a SEEDED shuffle must be
    # bit-deterministic end to end.
    yield from reducers


def repartition_exchange(refs: List[Any], k: int) -> Iterator[Any]:
    """Order-preserving repartition into k blocks via counted slices —
    reduce tasks pull exactly the ranges they need."""
    k = max(1, k)
    counts = ray_tpu_torch.get([_count_rows.remote(r) for r in refs])
    total = int(sum(counts))
    size = max(1, (total + k - 1) // k)
    offsets = np.cumsum([0] + list(counts))
    reducers = []
    for j in range(k):
        lo, hi = j * size, min((j + 1) * size, total)
        if lo >= hi:
            break
        pieces = []
        for bi, r in enumerate(refs):
            b_lo, b_hi = int(offsets[bi]), int(offsets[bi + 1])
            s, e = max(lo, b_lo), min(hi, b_hi)
            if s < e:
                pieces.append(_slice_block.remote(r, s - b_lo, e - b_lo))
        reducers.append(_reduce_concat.remote(*pieces))
    yield from reducers


def hash_exchange(refs: List[Any], op, reduce_kind: str) -> Iterator[Any]:
    """Hash-partition on the key; aggregate/map_groups per partition (all
    rows of one key land in one partition, so per-partition reduction is
    exact)."""
    p = _num_partitions(len(refs))
    key = op.key
    parts = _map_partitions(refs, _partition_hash_task, p,
                            lambda i: (key, p))
    reducer = _reduce_aggregate if reduce_kind == "aggregate" \
        else _reduce_map_groups
    reducers = [reducer.remote(op, *pp) for pp in parts]
    yield from _bounded(reducers)


# ----------------------------------------------------- global (key-less) agg
@ray_tpu_torch.remote
def _partial_states(blk: Block, specs) -> list:
    """One bounded partial state per aggregation spec."""
    acc = BlockAccessor(blk)
    out = []
    for col, fn in specs:
        if fn in ("count", "*count"):
            if col == "*":
                out.append(("count", acc.num_rows()))
            else:
                out.append(("count", len(block_mod.column_to_numpy(blk, col))))
            continue
        vals = np.asarray(block_mod.column_to_numpy(blk, col))
        if fn in ("quantile", "unique"):
            # No bounded partial: ship the COLUMN (not the block).
            out.append(("column", vals))
        elif fn == "sum":
            out.append(("sum", vals.sum() if len(vals) else 0.0))
        elif fn == "min":
            out.append(("min", vals.min() if len(vals) else None))
        elif fn == "max":
            out.append(("max", vals.max() if len(vals) else None))
        elif fn in ("mean", "std"):
            out.append(("moments", (len(vals), float(vals.sum()),
                                    float((vals.astype(np.float64) ** 2).sum()))))
        else:
            raise ValueError(f"unknown aggregation {fn!r}")
    return out


def global_aggregate(refs: List[Any], op) -> Block:
    """Combine per-block partials into the single result row."""
    from ray_tpu_torch.data.executor import _normalize_agg

    specs, metas = [], []
    for agg in op.aggs:
        col, fn, spec = _normalize_agg(agg)
        specs.append((col, fn))
        metas.append((col, fn, spec))
    partials = ray_tpu_torch.get([_partial_states.remote(r, specs) for r in refs])

    row = {}
    for i, (col, fn, spec) in enumerate(metas):
        states = [p[i] for p in partials]
        name = spec.output_name if spec is not None else f"{fn}({col})"
        if fn == "count" or col == "*":
            row[name] = int(sum(s[1] for s in states))
        elif fn == "sum":
            row[name] = sum(s[1] for s in states)
        elif fn == "min":
            vals = [s[1] for s in states if s[1] is not None]
            row[name] = min(vals) if vals else None
        elif fn == "max":
            vals = [s[1] for s in states if s[1] is not None]
            row[name] = max(vals) if vals else None
        elif fn in ("mean", "std"):
            n = sum(s[1][0] for s in states)
            tot = sum(s[1][1] for s in states)
            sq = sum(s[1][2] for s in states)
            if fn == "mean":
                row[name] = tot / n if n else None
            else:
                ddof = getattr(spec, "ddof", 1)
                var = (sq - tot * tot / n) / max(1, n - ddof) if n else None
                row[name] = float(np.sqrt(var)) if var is not None else None
        else:  # quantile / unique on the gathered column
            column = np.concatenate([np.asarray(s[1]) for s in states]) \
                if states else np.asarray([])
            if fn == "quantile":
                row[name] = float(np.quantile(column, getattr(spec, "q", 0.5)))
            else:
                row[name] = sorted(set(column.tolist()))
    return block_from_rows([row])
