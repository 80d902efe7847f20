"""Model multiplexing — many models per replica with LRU eviction (the
counterpart of ``ray_tpu/serve/multiplex.py``).

(ref: python/ray/serve/multiplex.py _ModelMultiplexWrapper — per-replica
LRU of loaded models keyed by model id, load via the user's @serve.multiplexed
function, evict least-recently-used above max_num_models_per_replica.)

Eviction actually releases resources: the evicted model goes through an
async-aware **unload hook** — the decorator's ``unload=`` callback when
given, else the model's own ``unload()`` / ``close()`` / sync-context
``__exit__`` — so device memory held by weights is freed, not left to the
garbage collector's mercy.  Loaded ids are pushed to replica metadata on
BOTH load and eviction, and forwarded to the controller so the router's
pow-2 scheduler can prefer warm replicas (see router.py).

Interplay with @serve.batch: the batching decorator keys its queues by the
request's multiplexed model id (serve_context.get_multiplexed_model_id()),
so requests for different models never share a micro-batch; one
vectorized call always targets a single set of loaded weights.
"""

from __future__ import annotations

import asyncio
import inspect
import sys
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.util import metrics as _metrics


def _telemetry():
    """Device-telemetry plane iff loaded (cross-layer probe idiom) —
    resident multiplexed weights (``tree_nbytes`` of what the loader
    returned) are accounted in its ``mux_weights`` pool, released on
    eviction."""
    return sys.modules.get("ray_tpu_torch.util.device_telemetry")

MODELS_LOADED_GAUGE = _metrics.Gauge(
    "serve_multiplexed_models_loaded",
    "Models currently resident in this replica's multiplex LRU",
    tag_keys=("deployment",))
MODEL_LOADS = _metrics.Counter(
    "serve_multiplexed_model_loads_total",
    "Model loads through @serve.multiplexed (cache misses)",
    tag_keys=("deployment",))
MODEL_EVICTIONS = _metrics.Counter(
    "serve_multiplexed_model_evictions_total",
    "LRU evictions that ran the unload hook",
    tag_keys=("deployment",))


async def _run_unload(model_id: str, model: Any,
                      unload_func: Optional[Callable],
                      self_arg: Any) -> None:
    """Release an evicted model through the first applicable hook:
    user callback > model.unload() > model.close() > model.__exit__.
    Sync or async everywhere; failures are swallowed (eviction must
    never wedge the loader)."""
    try:
        if unload_func is not None:
            args = (self_arg, model_id, model) if self_arg is not None \
                else (model_id, model)
            out = unload_func(*args)
        elif hasattr(model, "unload"):
            out = model.unload()
        elif hasattr(model, "close"):
            out = model.close()
        elif hasattr(model, "__exit__"):
            out = model.__exit__(None, None, None)
        else:
            return
        if inspect.isawaitable(out):
            await out
    except Exception:
        pass


class _ModelMultiplexWrapper:
    def __init__(self, model_load_func: Callable, self_arg: Any,
                 max_num_models_per_replica: int = 3,
                 unload_func: Optional[Callable] = None):
        self._load = model_load_func
        self._unload = unload_func
        self._self_arg = self_arg
        self._max = max_num_models_per_replica
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        #: model id -> bytes charged to the mux_weights pool at load time
        #: (evictions release exactly what the load charged, even if the
        #: model object mutated while resident).
        self._model_bytes: Dict[str, int] = {}
        self._lock = asyncio.Lock()
        self._tags = {"deployment": self._deployment_tag()}

    @staticmethod
    def _deployment_tag() -> str:
        from ray_tpu_torch.serve import context as serve_context

        ctx = serve_context.get_internal_replica_context()
        return ctx.deployment if ctx is not None else ""

    async def load_model(self, model_id: str) -> Any:
        if not isinstance(model_id, str) or not model_id:
            raise TypeError("model_id must be a non-empty string")
        async with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            while len(self._models) >= self._max:
                evicted_id, evicted = self._models.popitem(last=False)
                # Metadata reflects the eviction BEFORE the (possibly
                # slow) unload runs — the router must stop preferring
                # this replica for the evicted id immediately.
                self._push_model_ids()
                MODEL_EVICTIONS.inc(tags=self._tags)
                self._ledger_evicted(evicted_id)
                await _run_unload(evicted_id, evicted, self._unload,
                                  self._self_arg)
            args = (self._self_arg, model_id) if self._self_arg is not None \
                else (model_id,)
            model = self._load(*args)
            if inspect.isawaitable(model):
                model = await model
            self._models[model_id] = model
            MODEL_LOADS.inc(tags=self._tags)
            self._ledger_loaded(model_id, model)
            self._push_model_ids()
            return model

    async def unload_all(self) -> None:
        """Evict everything (replica shutdown / tests)."""
        async with self._lock:
            while self._models:
                evicted_id, evicted = self._models.popitem(last=False)
                self._push_model_ids()
                MODEL_EVICTIONS.inc(tags=self._tags)
                self._ledger_evicted(evicted_id)
                await _run_unload(evicted_id, evicted, self._unload,
                                  self._self_arg)

    def _ledger_loaded(self, model_id: str, model: Any) -> None:
        dt = _telemetry()
        if dt is None:
            return
        nbytes = dt.tree_nbytes(model)
        if nbytes:
            self._model_bytes[model_id] = nbytes
            dt.pool_add("mux_weights", nbytes)

    def _ledger_evicted(self, model_id: str) -> None:
        nbytes = self._model_bytes.pop(model_id, 0)
        if nbytes:
            dt = _telemetry()
            if dt is not None:
                dt.pool_sub("mux_weights", nbytes)

    @property
    def loaded_model_ids(self) -> list:
        """Currently loaded ids, LRU order (least-recent first)."""
        return list(self._models)

    def _push_model_ids(self) -> None:
        """Record loaded ids on the hosting replica's metadata and notify
        the controller (ref: multiplex.py _push_multiplexed_replica_info);
        the controller folds them into the routing table push so routers
        can prefer warm replicas.  Called on load AND eviction."""
        MODELS_LOADED_GAUGE.set(len(self._models), tags=self._tags)
        from ray_tpu_torch.serve import context as serve_context

        ctx = serve_context.get_internal_replica_context()
        if ctx is not None and ctx._replica is not None:
            ctx._replica.record_multiplexed_model_ids(list(self._models))


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3,
                unload: Optional[Callable] = None):
    """@serve.multiplexed decorator (ref: serve/api.py multiplexed).

    Args:
        max_num_models_per_replica: LRU capacity per replica.
        unload: optional (sync or async) callback run on eviction —
            ``unload(model_id, model)`` (methods get ``self`` first).
            Without it the model's own ``unload()``/``close()``/
            ``__exit__`` is used when present.
    """

    def decorate(func: Callable):
        if not inspect.iscoroutinefunction(func):
            raise TypeError("@serve.multiplexed requires an async def loader")
        wrappers = {}

        async def wrapped(*args) -> Any:
            # Methods get (self, model_id); functions get (model_id,).
            if len(args) == 2:
                self_arg, model_id = args
            else:
                self_arg, model_id = None, args[0]
            key = id(self_arg)
            wrapper = wrappers.get(key)
            if wrapper is None:
                wrapper = wrappers[key] = _ModelMultiplexWrapper(
                    func, self_arg, max_num_models_per_replica,
                    unload_func=unload)
            from ray_tpu_torch.serve import context as serve_context

            serve_context._set_request_model_id(model_id)
            return await wrapper.load_model(model_id)

        wrapped.__name__ = func.__name__
        wrapped._multiplex_wrappers = wrappers  # introspection / tests
        return wrapped

    if _func is not None:
        return decorate(_func)
    return decorate
