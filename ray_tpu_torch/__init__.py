"""ray_tpu_torch — the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package mirrors its module
names (``models.gpt2``, ``ops.attention``, ``serve``, the core API below)
and imports nothing of it. Every Pallas kernel of ``ray_tpu`` becomes a CUDA
kernel written by hand for sm_90a, under ``csrc/``, built at first use.

The core API is the reference's (ref: python/ray/_private/worker.py —
init:1275, get:2668, put:2804, wait:2869): tasks and actors run on threads
of this process, which share its CUDA context, or, with
``isolation="process"`` or a ``runtime_env``, in spawned worker processes
that see only the cards their lease names. Entry
points that touch a model run on the GPU unless the caller passes
``device="cpu"``. Importing the package initialises no CUDA.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import runtime as _rt
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime import ObjectRefGenerator
from ray_tpu_torch.actor import ActorClass, ActorHandle, exit_actor
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "cancel", "kill", "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "timeline", "ObjectRef", "ObjectRefGenerator",
    "ActorHandle", "exceptions", "exit_actor", "get_runtime_context",
    "get_gpu_ids", "resolve_device",
]


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    _system_config: Optional[dict] = None,
    labels: Optional[Dict[str, str]] = None,
):
    """Start the runtime in this process (ref: worker.py:1275 ray.init).

    The head node's resources are ``num_cpus`` CPUs (default: the host's),
    ``num_gpus`` GPUs (default: the CUDA devices torch counts; a whole
    number), ``memory`` and ``resources``; its labels are ``labels`` over
    the detected ``accelerator-type``. Virtual nodes join through
    ``cluster_utils.Cluster``; connecting to a cluster (``address``) comes
    with real worker nodes, which are not ported yet.
    """
    if address is not None:
        raise NotImplementedError(
            "ray_tpu_torch.init(address=...) needs the multi-node runtime, "
            "which is not ported yet (ROADMAP.md, Queue 1)")
    if _rt.runtime_or_none() is not None:
        if ignore_reinit_error:
            return _rt.get_runtime()
        raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
    return _rt.init_runtime(
        num_cpus=num_cpus,
        num_gpus=num_gpus,
        resources=resources,
        namespace=namespace,
        _system_config=_system_config,
        labels=labels,
    )


def shutdown() -> None:
    _rt.shutdown_runtime()


def is_initialized() -> bool:
    return _rt.runtime_or_none() is not None


def _ensure_init():
    if _rt.runtime_or_none() is None:
        init()
    return _rt.get_runtime()


def remote(*args, **options):
    """@remote decorator for functions and classes (ref: worker.py:3270 ray.remote)."""

    def decorate(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and callable(args[0]) and not options:
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return decorate


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    return _ensure_init().get(refs, timeout)


def put(value: Any) -> ObjectRef:
    return _ensure_init().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    return _ensure_init().wait(refs, num_returns, timeout, fetch_local)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    _ensure_init().cancel(ref, force)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _ensure_init().kill_actor(actor._ray_actor_id, no_restart)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    runtime = _ensure_init()
    actor_id = runtime.get_named_actor(name, namespace)
    state = runtime.get_actor_state(actor_id)
    return ActorHandle(actor_id, state.spec.cls, state.spec.max_task_retries)


def method(**options):
    """Per-method default options decorator (ref: ray.method)."""

    def decorate(m):
        m._ray_tpu_method_options = options
        return m

    return decorate


def nodes():
    return _ensure_init().nodes()


def cluster_resources() -> Dict[str, float]:
    return _ensure_init().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _ensure_init().available_resources()


def timeline(filename: Optional[str] = None) -> list:
    """Task timeline (ref: _private/state.py:960 ray.timeline).

    With no filename: the raw task-event dicts.  With a filename: writes
    chrome://tracing JSON (load at chrome://tracing / ui.perfetto.dev) and
    returns the chrome-trace event list.
    """
    runtime = _ensure_init()
    if filename is not None:
        from ray_tpu_torch._private import profiling

        return profiling.dump_timeline(filename)
    return runtime.list_task_events()


class _RuntimeContext:
    """(ref: python/ray/runtime_context.py)"""

    @property
    def job_id(self):
        return _ensure_init().job_id

    @property
    def node_id(self):
        return _ensure_init().head_node_id

    def get_task_id(self) -> Optional[str]:
        ctx = _rt.current_task_context()
        return str(ctx.task_id) if ctx else None

    def get_actor_id(self) -> Optional[str]:
        ctx = _rt.current_task_context()
        return str(ctx.actor_id) if ctx and ctx.actor_id else None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        ctx = _rt.current_task_context()
        if not ctx or not ctx.actor_id:
            return False
        state = _ensure_init().get_actor_state(ctx.actor_id)
        return bool(state and state.num_restarts > 0)


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()


def get_gpu_ids() -> list:
    """The GPU indices granted to the calling task, or to the actor whose
    constructor or threaded method is running (ref: worker.py
    ray.get_gpu_ids); empty outside them and for a lease without GPUs."""
    ctx = _rt.current_task_context()
    return list(ctx.gpu_ids) if ctx else []
