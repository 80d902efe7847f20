"""Dataset — lazy, streaming, distributed data (the counterpart of
``ray_tpu/data/dataset.py``; ref: python/ray/data/dataset.py:147).

Transforms append logical ops (plan.py); execution is streaming (executor.py)
and only happens on iteration/consumption, like the reference.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import executor as ex
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks
from ray_tpu_torch.data.plan import (
    ActorPoolStrategy,
    Aggregate,
    ComputeStrategy,
    Filter,
    FlatMap,
    InputData,
    Limit,
    LogicalOp,
    MapBatches,
    MapRows,
    RandomShuffle,
    Zip,
    Repartition,
    Sort,
    Union as UnionOp,
)


class Dataset:
    def __init__(self, op: LogicalOp):
        self._op = op

    # ------------------------------------------------------------ transforms
    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy", compute: Optional[ComputeStrategy] = None,
                    num_gpus: Optional[float] = None,
                    concurrency: Union[int, Tuple[int, int], None] = None,
                    fn_constructor_args: tuple = (), **_compat) -> "Dataset":
        """(ref: dataset.py:397 map_batches — the batch-inference path).

        Stateful form: pass a class; it is constructed once per pool actor
        (leasing ``num_gpus`` of one card, where the reference's actor leases
        ``num_tpus``; the constructor finds its card with
        ``_private.device.granted_cuda_device``) and called per batch.  ``concurrency``
        takes an int (fixed pool) or a ``(min, max)`` tuple (the pool
        autoscales between the bounds while the op is backlogged).
        """
        fn_constructor = None
        the_fn = fn
        if isinstance(fn, type):
            if compute is not None and not isinstance(compute, ActorPoolStrategy):
                raise ValueError(
                    "map_batches with a callable class requires an actor pool "
                    "(stateful fn); pass compute=ActorPoolStrategy(...) or omit "
                    "compute (ref: dataset.py map_batches compute validation)")
            ctor_args = fn_constructor_args

            def fn_constructor():
                return fn(*ctor_args)

            def the_fn(batch, state):
                return state(batch)

            if compute is None:
                compute = _pool_strategy(concurrency, num_gpus)
        elif num_gpus or (isinstance(concurrency, tuple)
                          or (concurrency and concurrency > 1)):
            compute = compute or _pool_strategy(concurrency, num_gpus)
        return Dataset(MapBatches(self._op, the_fn, batch_size=batch_size,
                                  batch_format=batch_format, compute=compute,
                                  fn_constructor=fn_constructor))

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return Dataset(MapRows(self._op, fn))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return Dataset(Filter(self._op, fn))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return Dataset(FlatMap(self._op, fn))

    def add_column(self, name: str, fn: Callable[[Dict], Any]) -> "Dataset":
        def add(row):
            row = dict(row)
            row[name] = fn(row)
            return row

        return Dataset(MapRows(self._op, add))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        return Dataset(MapBatches(self._op, drop))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch):
            return {k: batch[k] for k in cols}

        return Dataset(MapBatches(self._op, select))

    def limit(self, n: int) -> "Dataset":
        return Dataset(Limit(self._op, n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(Repartition(self._op, num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(RandomShuffle(self._op, seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return Dataset(Sort(self._op, key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(UnionOp(self._op, [o._op for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned column concat (ref: dataset.py Dataset.zip).  Lazy:
        the right side materializes at execution time, the left streams
        through keeping its block boundaries.  Duplicate column names from
        `other` get a unique "_N" suffix, as in the reference."""
        return Dataset(Zip(self._op, other._op))

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    # ----------------------------------------------------------- consumption
    def iter_block_refs(self) -> Iterator[Any]:
        return ex.execute(self._op)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     prefetch_batches: int = 0) -> Iterator[Any]:
        """(ref: iterator.py:94 iter_batches) — streaming, overlaps execution.

        ``prefetch_batches > 0`` pulls ahead on a background thread
        (data/ingest/prefetch.py) so block fetch + rebatch latency overlaps
        the consumer's work."""
        from ray_tpu_torch.data.block import rebatch

        blocks = (ray_tpu_torch.get(ref) for ref in self.iter_block_refs())
        batches = rebatch(blocks, batch_size, batch_format)
        if prefetch_batches > 0:
            from ray_tpu_torch.data.ingest.prefetch import HostPrefetcher

            prefetcher = HostPrefetcher(batches, depth=prefetch_batches)
            try:
                yield from prefetcher
            finally:
                prefetcher.close()
            return
        yield from batches

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device=None) -> Iterator[Any]:
        """(ref: iterator.py iter_torch_batches) — dict of torch tensors.

        ``device=None`` is the card of the calling task or actor (its
        lease's, else the current CUDA device) and raises without one;
        ``device="cpu"`` keeps the batch on the host."""
        import torch

        from ray_tpu_torch._private.device import (
            granted_cuda_device,
            resolve_device,
        )

        dev = resolve_device(device)
        if device is None:
            dev = granted_cuda_device()

        def to_tensor(k, v):
            if getattr(v, "dtype", None) is None or v.dtype.kind not in "biufc":
                return v  # non-numeric (strings/objects) stay numpy
            dt = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
            if dt is None and v.dtype.kind == "u" and v.dtype.itemsize > 1:
                # torch has no uint16/32/64: upcast to a signed type.
                v = v.astype(np.int64)
            return torch.as_tensor(np.array(v), dtype=dt).to(dev)

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy"):
            yield {k: to_tensor(k, v) for k, v in batch.items()}

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ref in self.iter_block_refs():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(
            BlockAccessor(ray_tpu_torch.get(r)).num_rows() for r in self.iter_block_refs())

    def schema(self):
        for ref in self.iter_block_refs():
            block = ray_tpu_torch.get(ref)
            if block.num_rows > 0 or block.schema.names:
                return block.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def materialize(self) -> "Dataset":
        """(ref: dataset.py materialize) — execute now, pin blocks."""
        refs = list(self.iter_block_refs())
        return Dataset(InputData(refs))

    def to_pandas(self):
        blocks = [ray_tpu_torch.get(r) for r in self.iter_block_refs()]
        return BlockAccessor(concat_blocks(blocks)).to_batch("pandas")

    def min(self, col: str):
        return self._simple_agg("min", col)

    def max(self, col: str):
        return self._simple_agg("max", col)

    def sum(self, col: str):
        return self._simple_agg("sum", col)

    def mean(self, col: str):
        return self._simple_agg("mean", col)

    def std(self, col: str, ddof: int = 1):
        """Sample standard deviation (ref: dataset.py:2415 Dataset.std)."""
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(col, ddof=ddof))

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (ref: dataset.py:2154 unique) —
        computed distributed via a grouped count, keys collected."""
        ds = self.select_columns([column]).groupby(column).count()
        return sorted(r[column] for r in ds.take_all())

    def aggregate(self, *aggs) -> Any:
        """Global aggregation (ref: dataset.py:2198 aggregate(*AggregateFn)).

        One spec returns its scalar; several return a dict keyed by each
        spec's output name."""
        ds = Dataset(Aggregate(self._op, None, list(aggs)))
        row = ds.take_all()[0]
        if len(aggs) == 1:
            return next(iter(row.values()))
        return row

    def _simple_agg(self, fn: str, col: str):
        ds = Dataset(Aggregate(self._op, None, [(col, fn)]))
        rows = ds.take_all()
        return rows[0][f"{fn}({col})"]

    # --------------------------------------------------------------- splits
    def split(self, n: int) -> List["Dataset"]:
        """Materializing equal split (ref: dataset.py split)."""
        refs = list(self.iter_block_refs())
        blocks = [ray_tpu_torch.get(r) for r in refs]
        merged = concat_blocks(blocks)
        acc = BlockAccessor(merged)
        total = acc.num_rows()
        size = (total + n - 1) // n if total else 0
        out = []
        for i in range(n):
            piece = acc.slice(min(i * size, total), min((i + 1) * size, total)) \
                if total else merged
            out.append(Dataset(InputData([ray_tpu_torch.put(piece)])))
        return out

    def streaming_split(self, n: int, *, equal: bool = True) -> List["DataIterator"]:
        """Coordinated split for Train ingest (ref: StreamSplitDataIterator,
        _internal/iterator/stream_split_iterator.py:31): one shared execution,
        blocks dealt round-robin to n consumers."""
        coordinator = _SplitCoordinator(self, n, equal=equal)
        return [DataIterator(coordinator, i) for i in range(n)]

    # ---------------------------------------------------------------- writes
    def _write_blocks(self, path: str, ext: str, write_one) -> None:
        """Distributed write: each block is written BY A TASK, in parallel,
        without materializing on the driver (ref: logical write operators in
        _internal/logical/operators/write_operator.py)."""
        import os

        os.makedirs(path, exist_ok=True)
        write_task = ray_tpu_torch.remote(write_one)
        refs = []
        for i, ref in enumerate(self.iter_block_refs()):
            out = os.path.join(path, f"part-{i:05d}.{ext}")
            refs.append(write_task.remote(ref, out))
        ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> None:
        self._write_blocks(path, "parquet", _write_block_parquet)

    def write_csv(self, path: str) -> None:
        self._write_blocks(path, "csv", _write_block_csv)

    def write_json(self, path: str) -> None:
        """Newline-delimited JSON, one file per block (ref: write_json)."""
        self._write_blocks(path, "json", _write_block_json)

    def write_tfrecords(self, path: str) -> None:
        """tf.train.Example TFRecord files, one per block — TensorFlow-
        readable framing + protos, no TF dependency (ref: write_tfrecords;
        data/tfrecords.py)."""
        self._write_blocks(path, "tfrecords", _write_block_tfrecords)

    def stats(self) -> str:
        return f"Dataset(plan={'->'.join(op.name for op in self._op.chain())})"

    def __repr__(self) -> str:
        return self.stats()


class GroupedData:
    """(ref: data/grouped_data.py)"""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def _agg(self, fn: str, col: str) -> Dataset:
        return Dataset(Aggregate(self._ds._op, self._key, [(col, fn)]))

    def sum(self, col: str) -> Dataset:
        return self._agg("sum", col)

    def min(self, col: str) -> Dataset:
        return self._agg("min", col)

    def max(self, col: str) -> Dataset:
        return self._agg("max", col)

    def mean(self, col: str) -> Dataset:
        return self._agg("mean", col)

    def count(self) -> Dataset:
        # Global count (key=None) counts rows of any column.
        col = self._key if self._key is not None else "*"
        return self._agg("count", col)

    def std(self, col: str, ddof: int = 1) -> Dataset:
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(col, ddof=ddof))

    def aggregate(self, *aggs) -> Dataset:
        """Multiple aggregations in one pass
        (ref: grouped_data.py:48 aggregate(*AggregateFn))."""
        return Dataset(Aggregate(self._ds._op, self._key, list(aggs)))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy") -> Dataset:
        """Apply ``fn`` to each group's batch; results concatenate into a new
        dataset (ref: grouped_data.py:93 map_groups)."""
        from ray_tpu_torch.data.plan import MapGroups

        return Dataset(MapGroups(self._ds._op, self._key, fn,
                                 batch_format=batch_format))


class _SplitCoordinator:
    """Shared execution behind n DataIterators (ref: StreamSplitDataIterator's
    coordinator actor, _internal/iterator/stream_split_iterator.py:31).

    One pump thread *per epoch*: each round of ``iter_batches`` calls across
    the n consumers re-executes the plan, so multi-epoch training loops work
    (the reference's DataIterator re-executes per epoch too).  Queues hold
    object *refs* (data lives in the object store) and are unbounded so a
    consumer that drains late — or not at all — can never wedge the pump and
    starve its peers.

    equal=True deals row-slices so every consumer gets ~1/n of each block —
    a one-block dataset still feeds all n trainers (the reference guarantees
    balanced output for Train ingest).
    """

    def __init__(self, ds: Dataset, n: int, equal: bool = True):
        self.ds = ds
        self.n = n
        self.equal = equal
        self._lock = threading.Lock()
        self._epochs: Dict[int, dict] = {}

    def queue_for(self, index: int, epoch: int) -> "queue.SimpleQueue":
        with self._lock:
            state = self._epochs.get(epoch)
            if state is None:
                queues = [queue.SimpleQueue() for _ in _builtin_range(self.n)]
                state = {"queues": queues, "done": 0}
                self._epochs[epoch] = state
                threading.Thread(target=self._pump, args=(queues,), daemon=True,
                                 name=f"split-pump-e{epoch}").start()
            return state["queues"][index]

    def finished(self, index: int, epoch: int) -> None:
        with self._lock:
            state = self._epochs.get(epoch)
            if state is not None:
                state["done"] += 1
                if state["done"] >= self.n:
                    del self._epochs[epoch]

    def _pump(self, queues: List["queue.SimpleQueue"]):
        i = 0
        error: Optional[BaseException] = None
        try:
            for ref in self.ds.iter_block_refs():
                if not self.equal:
                    queues[i % self.n].put(ref)
                    i += 1
                    continue
                block = ray_tpu_torch.get(ref)
                rows = BlockAccessor(block).num_rows()
                if rows == 0:
                    continue
                size = (rows + self.n - 1) // self.n
                acc = BlockAccessor(block)
                for c in _builtin_range(self.n):
                    start = min(c * size, rows)
                    end = min((c + 1) * size, rows)
                    if end > start:
                        # Rotate which consumer gets the (larger) head slice.
                        target = (c + i) % self.n
                        queues[target].put(ray_tpu_torch.put(acc.slice(start, end)))
                i += 1
        except BaseException as e:  # noqa: BLE001 — must reach the consumers
            error = e
        finally:
            # Execution errors propagate to every consumer rather than
            # silently truncating their streams.
            for q in queues:
                q.put(error if error is not None else None)


_builtin_range = range


class DataIterator:
    """Per-consumer iterator from streaming_split (ref: data/iterator.py:59).

    Re-iterable: each ``iter_batches`` call consumes one fresh epoch of the
    shared execution.
    """

    def __init__(self, coordinator: _SplitCoordinator, index: int):
        self._coord = coordinator
        self._index = index
        self._epoch = 0

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     prefetch_batches: int = 0) -> Iterator[Any]:
        from ray_tpu_torch.data.block import rebatch

        epoch = self._epoch
        self._epoch += 1
        q = self._coord.queue_for(self._index, epoch)

        def block_stream():
            try:
                while True:
                    ref = q.get()
                    if ref is None:
                        return
                    if isinstance(ref, BaseException):
                        raise ref
                    yield ray_tpu_torch.get(ref)
            finally:
                self._coord.finished(self._index, epoch)

        batches = rebatch(block_stream(), batch_size, batch_format)
        if prefetch_batches > 0:
            from ray_tpu_torch.data.ingest.prefetch import HostPrefetcher

            prefetcher = HostPrefetcher(batches, depth=prefetch_batches)
            try:
                yield from prefetcher
            finally:
                prefetcher.close()
            return
        yield from batches

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self.iter_batches(batch_size=None):
            n = len(next(iter(batch.values()))) if batch else 0
            for i in range(n):
                yield {k: v[i] for k, v in batch.items()}


def _pool_strategy(concurrency, num_gpus):
    """concurrency int -> fixed pool; (min, max) tuple -> autoscaling pool
    (ref: dataset.py map_batches concurrency semantics)."""
    res = {"GPU": num_gpus} if num_gpus else {}
    if isinstance(concurrency, tuple):
        lo, hi = concurrency
        return ActorPoolStrategy(min_size=lo, max_size=hi, resources=res)
    return ActorPoolStrategy(size=concurrency or 1, resources=res)


def _write_block_parquet(block, out_path):
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import block_to_arrow

    if block.num_rows:
        pq.write_table(block_to_arrow(block), out_path)


def _write_block_tfrecords(block, out_path):
    from ray_tpu_torch.data.block import BlockAccessor
    from ray_tpu_torch.data.tfrecords import row_to_example, write_records

    if block.num_rows:
        write_records(out_path, (row_to_example(row) for row in
                                 BlockAccessor(block).iter_rows()))


def _write_block_csv(block, out_path):
    import pyarrow.csv as pacsv

    from ray_tpu_torch.data.block import block_to_arrow

    if block.num_rows:
        pacsv.write_csv(block_to_arrow(block), out_path)


def _write_block_json(block, out_path):
    import json as _json

    if block.num_rows:
        cols = {name: [v.tolist() if isinstance(v, np.ndarray) else v
                       for v in block.column(name).tolist()]
                for name in block.column_names}
        with open(out_path, "w") as f:
            for i in _builtin_range(block.num_rows):
                row = {name: col[i] for name, col in cols.items()}
                f.write(_json.dumps(row, default=str) + "\n")
