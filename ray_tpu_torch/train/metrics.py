"""Train metrics (the counterpart of ``ray_tpu/train/metrics.py``).

Declared at import time like the serve metric modules; exported on
``/metrics`` through the process registry (util/metrics.py). The
reference's elastic series (preemptions, shrink and grow events, lost
steps, recovery seconds) come with the elastic path (ROADMAP.md, Queue 1
item 5); the world size keeps the reference's name.
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

WORLD_SIZE = Gauge(
    "ray_tpu_elastic_world_size",
    "Current world size of the training worker group",
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
