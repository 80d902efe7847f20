"""Actor classes and handles (the counterpart of ``ray_tpu/actor.py``; ref:
python/ray/actor.py — ActorClass:602, ActorClass._remote:890,
ActorHandle:1265).

``@ray_tpu_torch.remote`` on a class yields an ActorClass; ``.remote(...)``
schedules creation (resources held for the actor's lifetime) and returns an
ActorHandle whose method stubs submit ordered actor tasks.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import ActorID, TaskID
from ray_tpu_torch._private.option_utils import resolve_task_options
from ray_tpu_torch._private.runtime import get_runtime
from ray_tpu_torch._private.task_spec import ActorSpec, TaskSpec


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._method_name = method_name
        self._options = options or {}

    def options(self, **opts) -> "ActorMethod":
        merged = dict(self._options)
        merged.update(opts)
        return ActorMethod(self._handle, self._method_name, merged)

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(self._method_name, args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        """A lazy DAG node for this method on a live actor (dag/)."""
        from ray_tpu_torch.dag import ActorMethodNode

        return ActorMethodNode(self._handle, self._method_name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            f"use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, cls: type, max_task_retries: int = 0):
        self._actor_id = ActorID(actor_id)
        self._cls = cls
        self._max_task_retries = max_task_retries

    @property
    def _ray_actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if not callable(getattr(self._cls, name, None)):
            raise AttributeError(f"{self._cls.__name__} has no method '{name}'")
        return ActorMethod(self, name)

    def _submit_method(self, method_name: str, args, kwargs, options: Dict[str, Any]):
        runtime = get_runtime()
        method = getattr(self._cls, method_name)
        num_returns = options.get("num_returns", 1)
        generator = inspect.isgeneratorfunction(method) or num_returns in ("dynamic", "streaming")
        if not isinstance(num_returns, int):
            num_returns = 1
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            name=f"{self._cls.__name__}.{method_name}",
            func=method,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources={},
            max_retries=options.get("max_task_retries", self._max_task_retries),
            actor_id=self._actor_id,
            method_name=method_name,
            generator=generator,
        )
        return runtime.submit_actor_task(self._actor_id, spec)

    def __reduce__(self):
        return (ActorHandle, (str(self._actor_id), self._cls, self._max_task_retries))

    def __repr__(self) -> str:
        return f"ActorHandle({self._cls.__name__}, {self._actor_id})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls: type, default_options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._default_options = default_options or {}
        self.__name__ = cls.__name__

    def options(self, **options) -> "ActorClass":
        merged = dict(self._default_options)
        merged.update(options)
        return ActorClass(self._cls, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, **self._default_options)

    def _remote(self, args, kwargs, **options) -> ActorHandle:
        runtime = get_runtime()
        opts = resolve_task_options(options, is_actor=True)
        if opts["isolation"] == "process" or opts["runtime_env"]:
            has_async = any(
                inspect.iscoroutinefunction(getattr(self._cls, m, None))
                for m in dir(self._cls)
                if not m.startswith("__") or m == "__call__")
            if has_async:
                # Fail at creation, not as an opaque ActorDiedError on the
                # first method call.
                raise ValueError(
                    "async actors cannot use isolation='process' or a "
                    "runtime_env (the dedicated worker runs methods "
                    "synchronously)")
        actor_id = ActorID.from_random()
        spec = ActorSpec(
            actor_id=actor_id,
            name=opts.get("name"),
            namespace=opts.get("namespace") or runtime.namespace,
            cls=self._cls,
            args=args,
            kwargs=kwargs,
            resources=opts["resources"],
            max_restarts=opts["max_restarts"],
            max_task_retries=opts["max_task_retries"],
            max_concurrency=opts["max_concurrency"],
            lifetime=opts["lifetime"],
            isolation=opts["isolation"],
            runtime_env=opts["runtime_env"],
            strategy=opts["scheduling_strategy"],
        )
        runtime.create_actor(spec)
        return ActorHandle(actor_id, self._cls, opts["max_task_retries"])

    def bind(self, *args, **kwargs):
        """A lazy DAG node creating the actor at first execute (dag/)."""
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)


def exit_actor() -> None:
    """Terminate the current actor from inside a method (ref: ray.actor.exit_actor)."""
    from ray_tpu_torch._private.runtime import _ActorExit, current_task_context

    ctx = current_task_context()
    if ctx is None or ctx.actor_id is None:
        raise RuntimeError("exit_actor() called outside an actor method")
    raise _ActorExit()
