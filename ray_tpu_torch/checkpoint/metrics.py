"""Checkpoint subsystem metrics (the counterpart of
``ray_tpu/checkpoint/metrics.py``: the same series, names and tags).

Declared at import time like the serve metrics modules; exported through
the process registry on ``/metrics`` via the metrics agent
(util/metrics.py).

The anchor set mirrors what the Check-N-Run / Gemini papers measure:
how long the training step actually *blocks* for a save (the number async
checkpointing exists to shrink), how much the background tier writes,
commit latency, and recovery staleness (time between committed steps —
the worst-case recomputation window after a failure).
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

#: Seconds the training step was blocked by a save call (async: the
#: device->host snapshot only, with any wait for a free pinned buffer;
#: sync: the full persist + commit).
SAVE_BLOCK_SECONDS = Histogram(
    "ray_tpu_ckpt_save_block_seconds",
    "Seconds the caller was blocked by a checkpoint save "
    "(async saves: device-to-host snapshot only)",
    tag_keys=("mode",),
)

#: End-to-end duration of one shard's persist (background thread).
SAVE_SECONDS = Histogram(
    "ray_tpu_ckpt_save_seconds",
    "End-to-end seconds for one shard's persist (snapshot excluded)",
)

BYTES_WRITTEN = Counter(
    "ray_tpu_ckpt_bytes_written_total",
    "Bytes of checkpoint shard data written to storage",
)

COMMITS = Counter(
    "ray_tpu_ckpt_commits_total",
    "Checkpoints committed (two-phase commit completed: all shards "
    "landed, COMMIT marker written, directory renamed into place)",
)

COMMIT_SECONDS = Histogram(
    "ray_tpu_ckpt_commit_seconds",
    "Seconds for the commit phase (global manifest + COMMIT marker + "
    "atomic rename)",
)

SAVE_FAILURES = Counter(
    "ray_tpu_ckpt_save_failures_total",
    "Checkpoint save/commit attempts that failed (aborted pending saves "
    "included); tagged with the failing phase",
    tag_keys=("phase",),
)

#: Gap between the two most recent commits — the recomputation window a
#: failure right now would cost (0 until the second commit).
STALENESS_SECONDS = Gauge(
    "ray_tpu_ckpt_staleness_seconds",
    "Seconds between the last two committed checkpoints (worst-case "
    "lost-work window on failure)",
)

RESTORES = Counter(
    "ray_tpu_ckpt_restores_total",
    "Checkpoint restores, tagged with the tier that served them",
    tag_keys=("source",),
)

RESTORE_SECONDS = Histogram(
    "ray_tpu_ckpt_restore_seconds",
    "Seconds to assemble a full pytree from a committed checkpoint",
    tag_keys=("source",),
)

REPLICA_STEPS = Gauge(
    "ray_tpu_ckpt_replica_steps",
    "Checkpoint steps currently held in the in-memory replica tier",
)
