"""@ray_tpu_torch.remote functions (the counterpart of
``ray_tpu/remote_function.py``; ref: python/ray/remote_function.py:41).

``RemoteFunction._remote`` resolves options, builds a TaskSpec and submits
it to the runtime.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.option_utils import resolve_task_options
from ray_tpu_torch._private.runtime import get_runtime
from ray_tpu_torch._private.task_spec import TaskSpec


class RemoteFunction:
    def __init__(self, func: Callable, default_options: Optional[Dict[str, Any]] = None):
        if inspect.isclass(func):
            raise TypeError("Use @remote on classes via ActorClass (actor.py)")
        self._function = func
        self._default_options = default_options or {}
        # Options are static per instance (options() returns a new one):
        # resolved once per config generation, lazily, because a
        # module-level @remote runs before init() applies _system_config.
        self._resolved_opts = None
        self._resolved_gen = -1
        self._is_generator_fn = inspect.isgeneratorfunction(func)
        self.__name__ = getattr(func, "__name__", "remote_function")
        self.__doc__ = getattr(func, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use {self.__name__}.remote()."
        )

    def options(self, **options) -> "RemoteFunction":
        merged = dict(self._default_options)
        merged.update(options)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        if self._resolved_gen != GLOBAL_CONFIG.generation:
            self._resolved_opts = resolve_task_options(
                self._default_options, is_actor=False)
            self._resolved_gen = GLOBAL_CONFIG.generation
        return self._remote_resolved(args, kwargs, self._resolved_opts)

    def _remote_resolved(self, args, kwargs, opts):
        runtime = get_runtime()
        generator = self._is_generator_fn or opts["num_returns"] in (
            "dynamic", "streaming")
        num_returns = opts["num_returns"]
        if not isinstance(num_returns, int):
            num_returns = 1
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            name=opts.get("name") or self.__name__,
            func=self._function,
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources=opts["resources"],
            max_retries=opts["max_retries"],
            retry_exceptions=opts["retry_exceptions"],
            generator=generator,
            isolation=opts["isolation"],
            runtime_env=opts["runtime_env"],
            strategy=opts["scheduling_strategy"],
        )
        return runtime.submit_task(spec)

    def bind(self, *args, **kwargs):
        """DAG-building entry point (ref: dag/dag_node.py); returns a lazy
        node."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)
