"""Task/actor specifications (the counterpart of
``ray_tpu/_private/task_spec.py``; ref: src/ray/common/task/task_spec.h).

A TaskSpec carries everything needed to execute (and re-execute, for
lineage reconstruction) a task: the function, resolved-or-pending args,
resource request, retry budget.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, TaskID


class TaskSpec:
    # Kept lean: a spec is built on every .remote() call.
    __slots__ = (
        "task_id", "name", "func", "args", "kwargs", "num_returns",
        "resources", "max_retries", "retry_exceptions",
        "actor_id", "method_name", "attempt", "generator", "trace_ctx",
        "isolation", "runtime_env", "strategy",
    )

    def __init__(
        self,
        task_id: TaskID,
        name: str,
        func: Any,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        num_returns: int,
        resources: Dict[str, float],
        max_retries: int,
        retry_exceptions: bool = False,
        actor_id: Optional[ActorID] = None,
        method_name: str = "",
        generator: bool = False,
        isolation: str = "thread",
        runtime_env: Optional[dict] = None,
        strategy: Any = None,
    ):
        self.task_id = task_id
        self.name = name
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.num_returns = num_returns
        self.resources = resources
        self.max_retries = max_retries
        self.retry_exceptions = retry_exceptions
        self.actor_id = actor_id
        self.method_name = method_name
        self.attempt = 0
        self.generator = generator
        #: "process" (or a runtime_env) runs the task in a worker process.
        self.isolation = isolation
        self.runtime_env = runtime_env
        #: A PlacementGroupSchedulingStrategy, or None (the node).
        self.strategy = strategy
        #: Submitter's tracing context (util/tracing.py), propagated to the
        #: execute-side span.
        self.trace_ctx: Optional[dict] = None

    def __repr__(self) -> str:
        return f"TaskSpec({self.name}, id={self.task_id})"


class ActorSpec:
    __slots__ = (
        "actor_id", "name", "namespace", "cls", "args", "kwargs", "resources",
        "max_restarts", "max_task_retries", "max_concurrency",
        "lifetime", "isolation", "runtime_env", "strategy",
    )

    def __init__(
        self,
        actor_id: ActorID,
        name: Optional[str],
        namespace: str,
        cls: type,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        resources: Dict[str, float],
        max_restarts: int,
        max_task_retries: int,
        max_concurrency: int,
        lifetime: Optional[str],
        isolation: str = "thread",
        runtime_env: Optional[dict] = None,
        strategy: Any = None,
    ):
        self.actor_id = actor_id
        self.name = name
        self.namespace = namespace
        self.cls = cls
        self.args = args
        self.kwargs = kwargs
        self.resources = resources
        self.max_restarts = max_restarts
        self.max_task_retries = max_task_retries
        self.max_concurrency = max_concurrency
        self.lifetime = lifetime
        self.isolation = isolation
        self.runtime_env = runtime_env
        self.strategy = strategy
