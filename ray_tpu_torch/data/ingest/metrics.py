"""Streaming-ingest metrics.

Declared at import time like the serve/checkpoint/train metric modules so
``scripts/check_metrics.py`` lints them; exported on ``/metrics`` through
the process registry (util/metrics.py).

The anchor set is what an operator tuning an input pipeline needs: how
fast rows flow into training, whether the prefetch buffer is keeping the
step fed (occupancy), and how much step time the pipeline is costing when
it is not (starved seconds — the number that says "your input pipeline is
the bottleneck, raise prefetch_batches / reader parallelism").
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge

ROWS = Counter(
    "ray_tpu_data_ingest_rows_total",
    "Rows streamed into training by the ingest pipeline (rate = rows/s)",
)

BYTES = Counter(
    "ray_tpu_data_ingest_bytes_total",
    "Bytes of block data fetched from the object store by the ingest "
    "pipeline",
)

SHARDS = Counter(
    "ray_tpu_data_ingest_shards_total",
    "Source shards claimed and fully streamed by ingest workers",
)

FETCH_RETRIES = Counter(
    "ray_tpu_data_ingest_fetch_retries_total",
    "Block fetches retried after a transient failure (lost object, "
    "injected chaos) before training observed anything",
)

PREFETCH_OCCUPANCY = Gauge(
    "ray_tpu_data_ingest_prefetch_occupancy",
    "Batches currently buffered in the host prefetcher (0 while the "
    "training loop is outrunning the pipeline)",
)

WINDOW_BYTES = Gauge(
    "ray_tpu_data_ingest_window_bytes",
    "Bytes of block data currently resident in the shuffle window + "
    "fetch-ahead buffer (bounded by DatasetConfig.window_bytes)",
)

STARVED_SECONDS = Counter(
    "ray_tpu_data_ingest_starved_seconds_total",
    "Seconds the training loop spent blocked on an empty prefetch buffer "
    "(step starvation caused by the input pipeline)",
)

LOCAL_BYTES = Counter(
    "ray_tpu_data_ingest_local_bytes_total",
    "Block bytes materialized from this node's own object store "
    "(including local spill restores) — the locality-aware claimer's win",
)

CROSS_NODE_BYTES = Counter(
    "ray_tpu_data_ingest_cross_node_bytes_total",
    "Block bytes pulled over the object plane from another node — what "
    "locality-aware shard claiming exists to minimize",
)

SPILL_REFETCHES = Counter(
    "ray_tpu_data_ingest_spill_refetch_total",
    "Blocks restored from this node's local spill files instead of "
    "refetched over the network (spill-aware refetch)",
)

LOCALITY_CLAIMS = Counter(
    "ray_tpu_data_ingest_locality_claims_total",
    "Shard claims by locality outcome: 'local' when the claimed shard's "
    "object copies live on the reading node, 'remote' otherwise, 'blind' "
    "when the plan carries no locality information",
    tag_keys=("locality",),
)

PENDING_SHARDS = Gauge(
    "ray_tpu_data_ingest_pending_shards",
    "Unclaimed source shards summed across live streaming ingests (a "
    "cluster-autoscaler train-pressure signal)",
)
