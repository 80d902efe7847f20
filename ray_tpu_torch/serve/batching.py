"""Dynamic request micro-batching — ``@serve.batch`` (the counterpart of
``ray_tpu/serve/batching.py``).

(ref: python/ray/serve/batching.py — _BatchQueue coalesces concurrent
requests landing on one replica into a single vectorized invocation of the
user's callable and fans the results back out per request.)

The decorated function must take exactly one positional argument (plus
``self`` for methods) and, when invoked with a batch, receives a *list* of
those arguments and must return a list of the same length — one result per
request, in order.  Per-request error isolation: an ``Exception`` instance
in the returned list is raised only for its own request; the rest of the
batch completes normally.

Batches are keyed per multiplexed model id (``serve.context``): requests
being served by different models on the same replica never share a
vectorized call, mirroring the reference's per-model batch queues.

Adaptive timeout (``adaptive=True``, the default): the wait timeout counts
from the first queued request and *shrinks under load* — when batches fill
to ``max_batch_size`` before the timeout, the effective wait halves (down
to zero: take whatever is queued); when traffic thins out it grows back
toward ``batch_wait_timeout_s``.  Under sustained load this removes the
artificial wait latency entirely while keeping batches large (the queue
refills while the model runs), and under light load single requests still
flush within the configured bound.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve._sync import run_in_executor
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

#: Batch sizes per vectorized call (pow-2 buckets up to 128).
BATCH_SIZE_HISTOGRAM = _metrics.Histogram(
    "serve_batch_size",
    "Micro-batch size per vectorized callable invocation",
    boundaries=(1, 2, 4, 8, 16, 32, 64, 128),
    tag_keys=("deployment", "method"))
QUEUE_DEPTH_GAUGE = _metrics.Gauge(
    "serve_batch_queue_depth",
    "Requests waiting in the micro-batch queue at batch formation",
    tag_keys=("deployment", "method"))


def _deployment_tag() -> str:
    from ray_tpu_torch.serve import context as serve_context

    ctx = serve_context.get_internal_replica_context()
    return ctx.deployment if ctx is not None else ""


class _BatchQueue:
    """One batch queue + consumer task, bound to one event loop.

    (ref: serve/batching.py _BatchQueue — the consumer waits for a full
    batch or the wait timeout, invokes the wrapped function once, then
    distributes results/errors to the per-request futures.)
    """

    def __init__(self, func: Callable, self_arg: Any, cfg: Dict[str, Any],
                 model_id: str = ""):
        self._func = func
        self._self_arg = self_arg
        self._cfg = cfg
        self._tags = {"deployment": _deployment_tag(),
                      "method": getattr(func, "__name__", "batch")}
        self._queue: asyncio.Queue = asyncio.Queue()
        self._loop = asyncio.get_running_loop()
        #: adaptive effective wait; starts at the configured bound
        self.effective_timeout_s = float(cfg["batch_wait_timeout_s"])
        # detached_ok: consumer loop lives until the replica's event loop dies
        self._task = self._loop.create_task(self._consume_loop())
        self.model_id = model_id

    def submit(self, item: Any) -> asyncio.Future:
        fut = self._loop.create_future()
        # Entries carry their enqueue time + the request's trace context so
        # the consumer can attribute queue wait vs. execute per request —
        # the split Orca-style schedulers make essential.
        self._queue.put_nowait(
            (item, fut, time.time(), _tracing.active_span()))
        return fut

    # ------------------------------------------------------------ internals
    def _drain_ready(self, batch: list, max_size: int) -> None:
        while len(batch) < max_size and not self._queue.empty():
            batch.append(self._queue.get_nowait())

    async def _consume_loop(self) -> None:
        while True:
            batch: List[Tuple[Any, asyncio.Future, float, Optional[dict]]] \
                = [await self._queue.get()]
            max_size = int(self._cfg["max_batch_size"])
            timeout = (self.effective_timeout_s if self._cfg["adaptive"]
                       else float(self._cfg["batch_wait_timeout_s"]))
            deadline = self._loop.time() + timeout
            while len(batch) < max_size:
                remaining = deadline - self._loop.time()
                if remaining <= 0:
                    self._drain_ready(batch, max_size)
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), remaining))
                except asyncio.TimeoutError:
                    break
            self._adapt(len(batch), max_size)
            self._record_batch_formed(batch)
            await self._invoke(batch)

    def _record_batch_formed(
            self, batch: List[Tuple[Any, asyncio.Future, float,
                                    Optional[dict]]]) -> None:
        """Queue-wait attribution at batch formation: per request, the time
        from enqueue to now is queue wait (batch assembly included)."""
        from ray_tpu_torch.serve import metrics as serve_metrics

        now = time.time()
        QUEUE_DEPTH_GAUGE.set(self._queue.qsize(), tags=self._tags)
        first_ctx = next((ctx for _, _, _, ctx in batch if ctx), None)
        BATCH_SIZE_HISTOGRAM.observe(
            len(batch), tags=self._tags,
            exemplar=serve_metrics.trace_exemplar(first_ctx))
        serve_metrics.QUEUE_WAIT.observe_batch(
            [now - enq_t for _, _, enq_t, _ in batch], tags=self._tags,
            exemplar=serve_metrics.trace_exemplar(first_ctx))
        _tracing.record_span_batch(
            "serve.queue_wait",
            [(enq_t, now, ctx) for _, _, enq_t, ctx in batch],
            attributes=dict(self._tags, batch_size=len(batch)))

    def _adapt(self, batch_len: int, max_size: int) -> None:
        if not self._cfg["adaptive"]:
            return
        base = float(self._cfg["batch_wait_timeout_s"])
        if batch_len >= max_size:
            # Batches are filling before the timeout: stop paying wait
            # latency.  The queue refills while the model runs, so batch
            # sizes stay up even at zero wait.
            self.effective_timeout_s /= 2.0
            if self.effective_timeout_s < base / 64.0:
                self.effective_timeout_s = 0.0
        elif batch_len * 2 <= max_size:
            # Light traffic: wait longer again to rebuild batch sizes.
            self.effective_timeout_s = min(
                base, max(self.effective_timeout_s * 2.0, base / 32.0))

    def _record_executed(self, ctxs: List[Optional[dict]], exec_start: float,
                         serve_metrics) -> None:
        """Execution attribution: one histogram observation per vectorized
        call, plus a per-request execute span in each request's trace."""
        exec_end = time.time()
        first_ctx = next((c for c in ctxs if c), None)
        serve_metrics.EXECUTION.observe(
            exec_end - exec_start, tags=self._tags,
            exemplar=serve_metrics.trace_exemplar(first_ctx))
        _tracing.record_span_batch(
            "serve.batch_execute",
            [(exec_start, exec_end, ctx) for ctx in ctxs],
            attributes=dict(self._tags, batch_size=len(ctxs)))

    async def _invoke(self, batch: List[Tuple[Any, asyncio.Future, float,
                                              Optional[dict]]]) -> None:
        from ray_tpu_torch.serve import metrics as serve_metrics

        items = [item for item, _, _, _ in batch]
        futs = [fut for _, fut, _, _ in batch]
        ctxs = [ctx for _, _, _, ctx in batch]
        args = (items,) if self._self_arg is None else (self._self_arg, items)
        exec_start = time.time()
        try:
            if inspect.iscoroutinefunction(self._func):
                results = await self._func(*args)
            else:
                # Sync batch functions (the common forward pass on the GPU)
                # run on a worker thread so the replica loop keeps serving.
                results = await run_in_executor(self._func, *args)
            self._record_executed(ctxs, exec_start, serve_metrics)
            if (not isinstance(results, (list, tuple))
                    or len(results) != len(items)):
                got = (f"length {len(results)}"
                       if isinstance(results, (list, tuple))
                       else type(results).__name__)
                raise TypeError(
                    f"@serve.batch function "
                    f"{getattr(self._func, '__name__', self._func)!r} must "
                    f"return a list with one result per request "
                    f"(expected length {len(items)}, got {got})")
        except Exception as e:  # noqa: BLE001 — whole-batch failure
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
            return
        for fut, result in zip(futs, results):
            if fut.done():  # caller gave up (cancelled) — don't explode
                continue
            if isinstance(result, Exception):
                fut.set_exception(result)  # per-request error isolation
            else:
                fut.set_result(result)


def _split_call_args(args: tuple, kwargs: dict,
                     name: str) -> Tuple[Any, Any]:
    if kwargs or len(args) not in (1, 2):
        raise TypeError(
            f"@serve.batch function {name!r} takes exactly one positional "
            f"argument (the request payload; plus self for methods) so "
            f"requests can be coalesced into a list — got "
            f"args={len(args)}, kwargs={sorted(kwargs)}")
    if len(args) == 2:
        return args[0], args[1]
    return None, args[0]


def batch_fusion(fn: Any) -> Optional[Tuple[Callable, Dict[str, Any]]]:
    """``(inner_func, batch_config)`` when ``fn`` is a ``@serve.batch``
    wrapper, else None.  The compiled serve route (compiled_router.py) uses
    this to FUSE the micro-batch queue into its channel loop: having already
    coalesced a channel drain into one batch, it calls the undecorated inner
    function directly with the item list — same vectorized call, same
    per-request error-isolation contract, but no per-request asyncio future
    or queue hop.  ``functools.wraps`` pins ``__wrapped__`` to the original
    function, so the pair is always consistent with the wrapper's runtime
    setters (the config dict is shared, not copied)."""
    cfg = getattr(fn, "_batch_config", None)
    inner = getattr(fn, "__wrapped__", None)
    if cfg is None or inner is None:
        return None
    return inner, cfg


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01, adaptive: bool = True):
    """``@serve.batch`` — coalesce concurrent calls into vectorized ones.

    Args:
        max_batch_size: upper bound on requests per vectorized call.
        batch_wait_timeout_s: max time a partial batch waits for more
            requests before flushing.
        adaptive: shrink the effective wait under load (see module doc).

    The wrapper exposes ``set_max_batch_size`` / ``set_batch_wait_timeout_s``
    for runtime reconfiguration (ref: serve/batching.py _BatchingOptions
    setters) — new values apply from the next formed batch.
    """

    def decorate(func: Callable):
        if inspect.isasyncgenfunction(func) or inspect.isgeneratorfunction(func):
            raise TypeError(
                "@serve.batch wraps unary callables; for streaming "
                "generation use @serve.continuous_batch")
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if batch_wait_timeout_s < 0:
            raise ValueError("batch_wait_timeout_s must be >= 0")
        cfg: Dict[str, Any] = {
            "max_batch_size": int(max_batch_size),
            "batch_wait_timeout_s": float(batch_wait_timeout_s),
            "adaptive": bool(adaptive),
        }
        queues: Dict[Any, _BatchQueue] = {}

        @functools.wraps(func)
        async def wrapped(*args, **kwargs):
            self_arg, item = _split_call_args(args, kwargs, func.__name__)
            from ray_tpu_torch.serve import context as serve_context

            # Batches are keyed per multiplexed model id: a replica hosting
            # several models never mixes them in one vectorized call.
            model_id = serve_context.get_multiplexed_model_id()
            key = (id(self_arg), model_id)
            loop = asyncio.get_running_loop()
            q = queues.get(key)
            if q is None or q._loop is not loop or q._task.done():
                # First call on this (instance, model, loop) — or the old
                # consumer died with its loop (replica restart / process
                # tier's per-call loops): build a fresh queue here.
                q = queues[key] = _BatchQueue(func, self_arg, cfg, model_id)
            return await q.submit(item)

        wrapped._batch_config = cfg
        wrapped._batch_queues = queues  # introspection / tests
        wrapped.set_max_batch_size = (
            lambda n: cfg.__setitem__("max_batch_size", int(n)))
        wrapped.set_batch_wait_timeout_s = (
            lambda t: cfg.__setitem__("batch_wait_timeout_s", float(t)))
        return wrapped

    if _func is not None:
        return decorate(_func)
    return decorate
