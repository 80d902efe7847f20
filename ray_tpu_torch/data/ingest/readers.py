"""Offset-sharded file readers: reader parallelism beyond file count (the
counterpart of ``ray_tpu/data/ingest/readers.py``).

One read task per *file* caps parallelism at however many files the
dataset happens to have — one giant TFRecord shard serializes the whole
pipeline.  These builders split a single file into ``shards_per_file``
range shards:

* TFRecord: byte ranges.  A shard owns every record whose HEADER offset
  falls in its ``[start, end)`` range; a shard starting mid-record scans
  forward to the next CRC-verified frame boundary
  (``tfrecords.read_records_range``), so shards are disjoint and exactly
  cover the file without an index.
* Parquet: row-group ranges via the file's own metadata (row groups are
  parquet's native parallelism unit — no scanning needed).

Wired into ``data.read_tfrecords`` / ``data.read_parquet`` through their
``shards_per_file=`` argument.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional


def tfrecord_range_tasks(path: str,
                         shards_per_file: int) -> List[Callable[[], object]]:
    """Read tasks covering ``path`` in ``shards_per_file`` byte ranges."""
    size = os.path.getsize(path)
    shards = max(1, int(shards_per_file))
    if size == 0 or shards == 1:
        def read_all(path=path):
            from ray_tpu_torch.data.tfrecords import examples_to_block, read_records

            return examples_to_block(read_records(path))

        return [read_all]
    bounds = [size * i // shards for i in range(shards + 1)]

    def make_task(start: int, end: int):
        def read():
            from ray_tpu_torch.data.tfrecords import (
                examples_to_block,
                read_records_range,
            )

            return examples_to_block(read_records_range(path, start, end))

        return read

    return [make_task(lo, hi)
            for lo, hi in zip(bounds, bounds[1:]) if hi > lo]


def parquet_range_tasks(path: str, shards_per_file: int,
                        columns: Optional[List[str]] = None,
                        ) -> List[Callable[[], object]]:
    """Read tasks covering ``path``'s row groups in contiguous ranges."""
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import block_from_batch

    def read_all(path=path):
        return block_from_batch(pq.read_table(path, columns=columns))

    shards = max(1, int(shards_per_file))
    if shards == 1:
        return [read_all]
    n_groups = pq.ParquetFile(path).metadata.num_row_groups
    if n_groups == 0:
        # No row groups to range over (empty file): keep the single
        # read_all task so the file still contributes its (empty) block —
        # and its schema — instead of silently dropping out of the plan.
        return [read_all]
    shards = min(shards, n_groups)
    bounds = [n_groups * i // shards for i in range(shards + 1)]

    def make_task(lo: int, hi: int):
        def read():
            pf = pq.ParquetFile(path)
            return block_from_batch(
                pf.read_row_groups(list(range(lo, hi)), columns=columns))

        return read

    return [make_task(lo, hi)
            for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
