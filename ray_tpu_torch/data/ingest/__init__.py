"""Streaming training-ingestion subsystem (the counterpart of
``ray_tpu.data.ingest``; the reference's docs/data-ingestion.md).

Backpressured plan execution -> per-epoch windowed shuffle -> rebatch ->
host prefetch -> optional double-buffered device transfer, with
shard-level exactly-once accounting under elastic world changes.
"""

from ray_tpu_torch.data.ingest.executor import (
    fetch_block,
    shard_plans,
    shardable,
    stream_blocks,
)
from ray_tpu_torch.data.ingest.ingest import IngestShard, StreamingIngest
from ray_tpu_torch.data.ingest.prefetch import DeviceBatchIterator, HostPrefetcher
from ray_tpu_torch.data.ingest.readers import parquet_range_tasks, tfrecord_range_tasks
from ray_tpu_torch.data.ingest.shuffle import epoch_rng, window_shuffle

__all__ = [
    "DeviceBatchIterator",
    "HostPrefetcher",
    "IngestShard",
    "StreamingIngest",
    "epoch_rng",
    "fetch_block",
    "parquet_range_tasks",
    "shard_plans",
    "shardable",
    "stream_blocks",
    "tfrecord_range_tasks",
    "window_shuffle",
]
