"""ray_tpu_torch.serve.llm — the LLM inference subsystem (the counterpart
of ``ray_tpu.serve.llm``).

Ported so far: its metric registry (``metrics``) and the per-request and
per-token latency attribution (``attribution``) that feeds the SLO
watchdog's TTFT and inter-token objectives.  The engine itself — the paged
KV cache (``blocks``), the scheduler, the model, the engine step, the
prefill-to-decode handoff, the disaggregated deployments and the weight
store — comes with ROADMAP.md Queue 1 item 13, piece 7.
"""

from ray_tpu_torch.serve.llm import attribution, metrics
from ray_tpu_torch.serve.llm.attribution import RequestAttribution

__all__ = ["attribution", "metrics", "RequestAttribution"]
