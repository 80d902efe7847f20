"""Train metrics (the counterpart of ``ray_tpu/train/metrics.py``).

Declared at import time like the serve metric modules; exported on
``/metrics`` through the process registry (util/metrics.py).

The elastic series are what an operator of preemption-tolerant training
watches: how often nodes vanish, how the trainer responded (shrink and
grow), how much work each recovery cost (lost steps, bounded by
``CheckpointConfig.replica_memory_steps`` when the memory tier is on), and
how long a failure took to resume training.
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

PREEMPTIONS = Counter(
    "ray_tpu_elastic_preemptions_total",
    "Worker/node preemptions observed by the elastic training layer "
    "(simulated ones from the preempt_node chaos hook included)",
)

SHRINK_EVENTS = Counter(
    "ray_tpu_elastic_shrink_events_total",
    "Times the elastic trainer shrank its world size to surviving "
    "capacity after a worker or node loss",
)

GROW_EVENTS = Counter(
    "ray_tpu_elastic_grow_events_total",
    "Times the elastic trainer grew its world size back at a checkpoint "
    "boundary after capacity returned",
)

LOST_STEPS = Counter(
    "ray_tpu_elastic_lost_steps_total",
    "Training steps rolled back across all elastic recoveries (steps "
    "reported after the last committed checkpoint at failure time)",
)

RECOVERY_SECONDS = Histogram(
    "ray_tpu_elastic_recovery_seconds",
    "Seconds from failure detection to the first report() of the resumed "
    "attempt (restore + group reform + data reshard)",
)

WORLD_SIZE = Gauge(
    "ray_tpu_elastic_world_size",
    "Current world size of the elastic training worker group",
)

# ---------------------------------------------------------------- profiler
# Live step-time attribution from ray_tpu_torch.train.profiler: every
# step's wall clock split into data-wait / h2d / compute / collective /
# ckpt-block buckets, plus the derived MFU / tokens-per-second /
# starvation gauges.

STEPS_PROFILED = Counter(
    "ray_tpu_train_steps_total",
    "Training steps closed by the step profiler (report() boundaries)",
)

STEP_SECONDS = Histogram(
    "ray_tpu_train_step_seconds",
    "Wall seconds per training step, report() to report()",
    boundaries=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)

STEP_P50_SECONDS = Gauge(
    "ray_tpu_train_step_p50_seconds",
    "Median step wall time over the profiler's recent-step window",
)

STEP_P95_SECONDS = Gauge(
    "ray_tpu_train_step_p95_seconds",
    "95th-percentile step wall time over the profiler's recent-step window",
)

STEP_BUCKET_SECONDS = Gauge(
    "ray_tpu_train_step_bucket_seconds",
    "Last step's wall-time attribution per bucket (data_wait / h2d / "
    "compute / collective / ckpt_block); buckets sum to the step wall",
    ("bucket",),
)

DATA_STARVED_FRACTION = Gauge(
    "ray_tpu_train_data_starved_fraction",
    "Fraction of the last step's wall time spent blocked on the input "
    "pipeline (the per-step view of ingest starved-seconds)",
)

TOKENS_PER_SECOND = Gauge(
    "ray_tpu_train_tokens_per_second",
    "Training throughput from the step profiler (requires "
    "profiler.configure(tokens_per_step=...))",
)

MFU = Gauge(
    "ray_tpu_train_mfu",
    "Model FLOPs utilization of the last step: flops_per_step / wall / "
    "peak_flops (requires profiler.configure(flops_per_step=..., "
    "peak_flops=...))",
)
