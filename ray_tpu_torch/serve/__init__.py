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
through those three, and ``GPT2Stage`` a span of its layers for a
forward split over actors or pipeline stages. ``slo`` holds the SLO objectives and the burn-rate
watchdog that ``serve.status()``, the metrics agent's ``/api/serve/slo``
and the autoscaler's SLO-burn policy read.

Replicas are async actors of the thread tier, or, with
``ray_actor_options={"isolation": "process"}`` (or a ``runtime_env``),
``SyncReplicaActor`` in worker processes of their own. ``serve.device`` is
the device-telemetry plane (``util/device_telemetry.py``: pools, the
transfer ledger, ``transfer_bw``). Once a replica set is stable, routers
lower unary requests onto compiled channel lanes (``compiled_router.py``:
in-process channels for thread-tier replicas, shared-memory channels
(``SharedMemoryChannel``) over the object store's arena for process-tier
ones;
``RAY_TPU_SERVE_COMPILED=0`` or ``compiled_route=False`` keeps the dynamic
path), and ``serve.pipeline`` chains deployments over ``DeviceChannel``
edges, a process stage's hop crossing its lane's shared-memory channels.
Not ported yet (ROADMAP.md, Queue 1): lanes to replicas on worker nodes
(item 13.8b), the gRPC proxy and the LLM engine.
"""

from ray_tpu_torch.serve import metrics, slo
from ray_tpu_torch.util import device_telemetry as device
from ray_tpu_torch.serve.api import (Application, Deployment, delete,
                                     deployment, get_app_handle,
                                     get_deployment_handle, list_deployments,
                                     list_replicas, pipeline, run, shutdown,
                                     start, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                        HTTPOptions)
from ray_tpu_torch.serve.context import get_multiplexed_model_id
from ray_tpu_torch.serve.continuous import (EOS, Emissions, SequenceSlot,
                                            continuous_batch)
from ray_tpu_torch.serve.exceptions import BackPressureError
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.serve.proxy import Request
from ray_tpu_torch.serve.slo import SLOObjective

__all__ = [
    "Application", "Deployment", "deployment", "run", "start", "shutdown",
    "delete", "status", "get_app_handle", "get_deployment_handle",
    "list_deployments", "list_replicas", "pipeline", "AutoscalingConfig",
    "DeploymentConfig", "HTTPOptions", "DeploymentHandle",
    "DeploymentResponse", "Request", "multiplexed",
    "get_multiplexed_model_id", "batch", "continuous_batch", "EOS",
    "Emissions", "SequenceSlot", "BackPressureError", "SLOObjective",
    "metrics", "slo", "device",
    "GPT2Next", "GPT2Stream", "GPT2BatchNext", "GPT2ContinuousStream",
    "GPT2MultiplexNext", "GPT2Stage",
]

#: The GPT-2 bodies (``serve/gpt2.py``) load torch, so they are imported on
#: first use: a process replica that serves no model starts without torch.
_GPT2 = ("GPT2Next", "GPT2Stream", "GPT2BatchNext", "GPT2ContinuousStream",
         "GPT2MultiplexNext", "GPT2Stage")


def __getattr__(name):
    if name in _GPT2:
        from ray_tpu_torch.serve import gpt2

        return getattr(gpt2, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
