"""ray_tpu_torch.serve — model serving library (the counterpart of
``ray_tpu.serve``; ref: python/ray/serve/).

A controller reconciles deployment and replica state, routers pick
replicas by power-of-two choices (preferring replicas that hold a request's
multiplexed model), and an HTTP proxy (standard library only) serves unary
and streamed (chunked, SSE) requests; replicas are async actors of the
thread tier. ``@serve.batch`` coalesces concurrent calls into one
vectorized call, ``@serve.continuous_batch`` steps every in-flight stream
in one shared call per iteration, and ``@serve.multiplexed`` keeps an LRU
of models per replica. ``GPT2Next`` and ``GPT2Stream`` are the GPT-2
replica bodies of ``examples/serve_gpt2.py``; ``GPT2BatchNext``,
``GPT2ContinuousStream`` and ``GPT2MultiplexNext`` serve the same model
through those three.

Not ported yet (ROADMAP.md, Queue 1): SLO objectives and the metrics
agent, the compiled router, the gRPC proxy, the LLM stack and the process
tier.
"""

from ray_tpu_torch.serve import metrics
from ray_tpu_torch.serve.api import (Application, Deployment, delete,
                                     deployment, get_app_handle,
                                     get_deployment_handle, list_deployments,
                                     list_replicas, run, shutdown, start,
                                     status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                        HTTPOptions)
from ray_tpu_torch.serve.context import get_multiplexed_model_id
from ray_tpu_torch.serve.continuous import (EOS, Emissions, SequenceSlot,
                                            continuous_batch)
from ray_tpu_torch.serve.exceptions import BackPressureError
from ray_tpu_torch.serve.gpt2 import (GPT2BatchNext, GPT2ContinuousStream,
                                      GPT2MultiplexNext, GPT2Next,
                                      GPT2Stream)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.serve.proxy import Request

__all__ = [
    "Application", "Deployment", "deployment", "run", "start", "shutdown",
    "delete", "status", "get_app_handle", "get_deployment_handle",
    "list_deployments", "list_replicas", "AutoscalingConfig",
    "DeploymentConfig", "HTTPOptions", "DeploymentHandle",
    "DeploymentResponse", "Request", "multiplexed",
    "get_multiplexed_model_id", "batch", "continuous_batch", "EOS",
    "Emissions", "SequenceSlot", "BackPressureError", "metrics",
    "GPT2Next", "GPT2Stream", "GPT2BatchNext", "GPT2ContinuousStream",
    "GPT2MultiplexNext",
]
