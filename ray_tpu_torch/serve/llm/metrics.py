"""Metrics for the LLM inference engine (the counterpart of
``ray_tpu/serve/llm/metrics.py``).

One module owns every engine metric so names stay consistent across the
block allocator, scheduler, disaggregated pools, and the multiplex layer.
Tags use ``pool`` to distinguish prefill-heavy vs decode-heavy replica
pools ("engine" for the monolithic engine).  The attribution layer
(``attribution.py``) feeds the TTFT and inter-token series today; the
engine's series stay at zero until the engine lands (ROADMAP.md, Queue 1
item 13, piece 7).
"""

from __future__ import annotations

from ray_tpu_torch.util import metrics as _metrics

BLOCKS_TOTAL = _metrics.Gauge(
    "ray_tpu_llm_kv_blocks_total",
    "Fixed-size KV-cache blocks in the preallocated pool",
    tag_keys=("pool",))
BLOCKS_IN_USE = _metrics.Gauge(
    "ray_tpu_llm_kv_blocks_in_use",
    "KV-cache blocks currently allocated (refcount > 0)",
    tag_keys=("pool",))
BLOCK_ALLOCS = _metrics.Counter(
    "ray_tpu_llm_block_allocs_total",
    "KV-cache block allocations served from the pool",
    tag_keys=("pool",))
COW_COPIES = _metrics.Counter(
    "ray_tpu_llm_block_cow_copies_total",
    "Copy-on-write block materializations (forked sequence diverged)",
    tag_keys=("pool",))
PREEMPTIONS = _metrics.Counter(
    "ray_tpu_llm_preemptions_total",
    "Sequences preempted under block pressure (recompute-on-resume)",
    tag_keys=("pool",))
PREFILL_TOKENS = _metrics.Counter(
    "ray_tpu_llm_prefill_tokens_total",
    "Prompt tokens prefilled into the paged KV cache",
    tag_keys=("pool",))
DECODE_TOKENS = _metrics.Counter(
    "ray_tpu_llm_decode_tokens_total",
    "Tokens emitted by decode iterations",
    tag_keys=("pool",))
KV_HANDOFFS = _metrics.Counter(
    "ray_tpu_llm_kv_handoffs_total",
    "Prefill→decode KV-page handoffs completed",
    tag_keys=("transport",))
KV_HANDOFF_BYTES = _metrics.Counter(
    "ray_tpu_llm_kv_handoff_bytes_total",
    "Bytes of KV pages moved prefill→decode",
    tag_keys=("transport",))
WAITING_SEQUENCES = _metrics.Gauge(
    "ray_tpu_llm_waiting_sequences",
    "Sequences waiting for prefill admission (insufficient block headroom)",
    tag_keys=("pool",))
RUNNING_SEQUENCES = _metrics.Gauge(
    "ray_tpu_llm_running_sequences",
    "Sequences in the decode batch of the engine scheduler",
    tag_keys=("pool",))

# Latency attribution: request-level histograms carry trace-id
# exemplars (the serve.metrics pattern) so a p99 outlier links straight
# to its trace.  Boundaries are shared with the serve request histograms
# so TTFT and full-request latency are comparable bucket-for-bucket.
from ray_tpu_torch.serve.metrics import LATENCY_BOUNDARIES as _LATENCY_BOUNDARIES

TTFT_SECONDS = _metrics.Histogram(
    "ray_tpu_llm_ttft_seconds",
    "Time to first token, request submit to first emission",
    boundaries=_LATENCY_BOUNDARIES,
    tag_keys=("deployment", "pool"))
INTER_TOKEN_SECONDS = _metrics.Histogram(
    "ray_tpu_llm_inter_token_seconds",
    "Gap between consecutive token emissions of one request",
    boundaries=_LATENCY_BOUNDARIES,
    tag_keys=("deployment", "pool"))
TTFT_BUCKET_SECONDS = _metrics.Histogram(
    "ray_tpu_llm_ttft_bucket_seconds",
    "One named TTFT attribution bucket (queue/admission/prefill/handoff/"
    "residual); buckets of a request sum to its TTFT",
    boundaries=_LATENCY_BOUNDARIES,
    tag_keys=("bucket", "pool"))
HANDOFF_SECONDS = _metrics.Histogram(
    "ray_tpu_llm_kv_handoff_seconds",
    "KV-page export/import latency per handoff",
    boundaries=_LATENCY_BOUNDARIES,
    tag_keys=("transport", "direction"))
RECOMPUTE_TOKENS = _metrics.Counter(
    "ray_tpu_llm_recompute_tokens_total",
    "Tokens re-prefilled after preemption (throughput counted twice; the "
    "waste term in goodput accounting)",
    tag_keys=("pool",))
BATCH_OCCUPANCY = _metrics.Gauge(
    "ray_tpu_llm_batch_occupancy",
    "Continuous-batch fill fraction per engine step (live slots / batch "
    "capacity)",
    tag_keys=("pool",))

# Speculative decoding: the accepted/proposed pair feeds the
# serve.metrics.acceptance_rate() windowed accessor; rollbacks and
# fallbacks are the safety-valve counters the chaos suite asserts on.
SPEC_PROPOSED_TOKENS = _metrics.Counter(
    "ray_tpu_llm_spec_proposed_tokens_total",
    "Draft tokens proposed to the speculative verify pass",
    tag_keys=("pool",))
SPEC_ACCEPTED_TOKENS = _metrics.Counter(
    "ray_tpu_llm_spec_accepted_tokens_total",
    "Draft tokens the target verification accepted",
    tag_keys=("pool",))
SPEC_VERIFY_STEPS = _metrics.Counter(
    "ray_tpu_llm_spec_verify_steps_total",
    "Batched speculative verify passes executed",
    tag_keys=("pool",))
SPEC_ROLLBACK_TOKENS = _metrics.Counter(
    "ray_tpu_llm_spec_rollback_tokens_total",
    "Rejected or over-budget draft KV entries truncated from block tables",
    tag_keys=("pool",))
SPEC_FALLBACKS = _metrics.Counter(
    "ray_tpu_llm_spec_fallbacks_total",
    "Verify-step failures degraded to a plain one-token decode",
    tag_keys=("pool",))

# Cluster prefix cache + KV tiering: the lookup/hit pair feeds
# serve.metrics.prefix_hit_rate(); demoted/promoted and the occupancy
# gauge track pages moving between the device, host, and object tiers.
PREFIX_LOOKUP_TOKENS = _metrics.Counter(
    "ray_tpu_llm_prefix_lookup_tokens_total",
    "Full-block prompt tokens checked against the replica prefix cache",
    tag_keys=("pool",))
PREFIX_HIT_TOKENS = _metrics.Counter(
    "ray_tpu_llm_prefix_hit_tokens_total",
    "Prompt tokens served from cached prefix blocks instead of prefill",
    tag_keys=("pool",))
PREFIX_MISS_TOKENS = _metrics.Counter(
    "ray_tpu_llm_prefix_miss_tokens_total",
    "Full-block prompt tokens that missed the prefix cache",
    tag_keys=("pool",))
PREFIX_CACHE_BLOCKS = _metrics.Gauge(
    "ray_tpu_llm_prefix_cache_blocks",
    "Committed device blocks pinned by the replica prefix cache",
    tag_keys=("pool",))
KV_DEMOTED_PAGES = _metrics.Counter(
    "ray_tpu_llm_kv_demoted_pages_total",
    "KV pages demoted out of the device pool into a colder tier",
    tag_keys=("pool", "tier"))
KV_PROMOTED_PAGES = _metrics.Counter(
    "ray_tpu_llm_kv_promoted_pages_total",
    "KV pages promoted from a cold tier back into the device pool",
    tag_keys=("pool", "tier"))
TIER_PAGES = _metrics.Gauge(
    "ray_tpu_llm_kv_tier_pages",
    "KV pages currently resident in one cold tier (host or object store)",
    tag_keys=("pool", "tier"))
