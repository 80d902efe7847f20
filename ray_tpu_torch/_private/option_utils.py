"""Validation/resolution of @remote options (the counterpart of
``ray_tpu/_private/option_utils.py``; ref: ray_option_utils.py).

Resources are ``CPU`` (``num_cpus``), ``GPU`` (``num_gpus``), ``memory``
(bytes) and custom ones (``resources={...}``); more than one GPU must be a
whole number of them. A ``scheduling_strategy`` of
``util/scheduling_strategies.py`` chooses the node, and a
``PlacementGroupSchedulingStrategy`` leases from its group's bundle. Tasks and actors
run on the thread tier unless they give ``isolation="process"`` or a
``runtime_env`` (``_private/runtime_env.py``, staged when the task runs),
which run them in worker processes.
"""

from __future__ import annotations

from typing import Any, Dict

_COMMON_KEYS = {
    "num_cpus", "num_gpus", "memory", "resources", "scheduling_strategy",
    "name", "runtime_env", "isolation", "_metadata",
}
_TASK_KEYS = _COMMON_KEYS | {"num_returns", "max_retries", "retry_exceptions"}
_ACTOR_KEYS = _COMMON_KEYS | {
    "max_restarts", "max_task_retries", "max_concurrency", "lifetime",
    "namespace", "max_pending_calls",
}


def resolve_task_options(options: Dict[str, Any], is_actor: bool) -> Dict[str, Any]:
    allowed = _ACTOR_KEYS if is_actor else _TASK_KEYS
    unknown = set(options) - allowed
    if unknown:
        raise ValueError(f"Unknown options {sorted(unknown)}; allowed: {sorted(allowed)}")
    isolation = options.get("isolation", "thread")
    if isolation not in ("thread", "process"):
        raise ValueError("isolation must be 'thread' or 'process'")

    resources: Dict[str, float] = dict(options.get("resources") or {})
    if "num_cpus" in options and options["num_cpus"] is not None:
        if "CPU" in resources and float(options["num_cpus"]) != resources["CPU"]:
            raise ValueError(
                "Specify CPU either via num_cpus or resources={'CPU': ...}, not "
                "both (they conflict).")
        resources["CPU"] = float(options["num_cpus"])
    else:
        # Tasks default to 1 CPU; actors to 0 (they hold placement, not
        # cores) — the reference's defaults.
        resources.setdefault("CPU", 0.0 if is_actor else 1.0)
    if options.get("num_gpus") is not None:
        resources["GPU"] = float(options["num_gpus"])
    if resources.get("GPU", 0.0) > 1 and resources["GPU"] != int(resources["GPU"]):
        raise ValueError(
            f"num_gpus above 1 must be a whole number, got {resources['GPU']}")
    if options.get("memory") is not None:
        resources["memory"] = float(options["memory"])
    for key in [k for k, v in resources.items() if v == 0.0]:
        resources.pop(key)

    out: Dict[str, Any] = {
        "resources": resources,
        "name": options.get("name"),
        "isolation": isolation,
        "runtime_env": options.get("runtime_env"),
        "scheduling_strategy": _placement_strategy(
            options.get("scheduling_strategy")),
    }
    if is_actor:
        out["max_restarts"] = int(options.get("max_restarts", 0))
        out["max_task_retries"] = int(options.get("max_task_retries", 0))
        out["max_concurrency"] = int(options.get("max_concurrency", 1))
        out["lifetime"] = options.get("lifetime")
        out["namespace"] = options.get("namespace")
    else:
        nr = options.get("num_returns", 1)
        if not (isinstance(nr, int) and nr >= 0) and nr not in ("dynamic", "streaming"):
            raise ValueError(f"Invalid num_returns: {nr}")
        out["num_returns"] = nr
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        mr = options.get("max_retries")
        out["max_retries"] = GLOBAL_CONFIG.task_max_retries if mr is None else int(mr)
        out["retry_exceptions"] = bool(options.get("retry_exceptions", False))
    return out


def _placement_strategy(strategy: Any) -> Any:
    """The strategy the scheduler acts on: a strategy object, else None
    (the default, hybrid policy)."""
    from ray_tpu_torch._private.scheduling import (
        DefaultStrategy,
        SchedulingStrategy,
    )

    if isinstance(strategy, SchedulingStrategy) and \
            type(strategy) is not DefaultStrategy:
        return strategy
    return None
