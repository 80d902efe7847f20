"""ray_tpu_torch.serve — model serving library (the counterpart of
``ray_tpu.serve``; ref: python/ray/serve/).

A controller reconciles deployment and replica state, routers pick
replicas by power-of-two choices, and an HTTP proxy (standard library
only) serves unary and streamed (chunked, SSE) requests; replicas are async
actors of the thread tier. ``GPT2Next`` and ``GPT2Stream`` are the GPT-2
replica bodies of ``examples/serve_gpt2.py``.

Not ported yet (ROADMAP.md, Queue 1): ``serve.batch`` and continuous
batching, multiplexing, SLO objectives, the compiled router, the gRPC
proxy and the LLM stack.
"""

from ray_tpu_torch.serve import metrics
from ray_tpu_torch.serve.api import (Application, Deployment, delete,
                                     deployment, get_app_handle,
                                     get_deployment_handle, list_deployments,
                                     list_replicas, run, shutdown, start,
                                     status)
from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                        HTTPOptions)
from ray_tpu_torch.serve.exceptions import BackPressureError
from ray_tpu_torch.serve.gpt2 import GPT2Next, GPT2Stream
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.proxy import Request

__all__ = [
    "Application", "Deployment", "deployment", "run", "start", "shutdown",
    "delete", "status", "get_app_handle", "get_deployment_handle",
    "list_deployments", "list_replicas", "AutoscalingConfig",
    "DeploymentConfig", "HTTPOptions", "DeploymentHandle",
    "DeploymentResponse", "Request", "BackPressureError", "metrics",
    "GPT2Next", "GPT2Stream",
]
