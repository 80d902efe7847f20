"""Replica — the actor hosting one copy of a deployment's user callable
(the counterpart of ``ray_tpu/serve/replica.py``).

(ref: python/ray/serve/_private/replica.py — Replica:750 actor +
UserCallableWrapper:1017 which invokes the user's sync/async
callable/generator; queue length reported for the pow-2 router.)

Replicas are async actors of the thread tier, so a replica that serves a
model on the GPU runs its CUDA work on the runtime's threads: the replica
body sets its device on whichever thread calls it
(``ray_tpu_torch/serve/gpt2.py``). The process-tier replica
(``SyncReplicaActor``) comes with the process tier (ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict

from ray_tpu_torch.serve._sync import run_in_executor
from ray_tpu_torch.util import tracing as _tracing

#: StopIteration cannot cross an executor future back into a coroutine
#: (it would surface as RuntimeError), so sync-iterator pulls return this.
_STREAM_DONE = object()


def _is_async_callable(target: Any) -> bool:
    """Is this target's body a coroutine/async-generator function?"""
    fn = target if (inspect.isfunction(target) or inspect.ismethod(target)) \
        else getattr(target, "__call__", None)
    return fn is not None and (inspect.iscoroutinefunction(fn)
                               or inspect.isasyncgenfunction(fn))


def _invoke_sync_unary(target: Any, args: tuple, kwargs: dict) -> Any:
    """Runs fully on an executor thread: the call AND the generator drain
    (a sync generator's body executes during the drain)."""
    result = target(*args, **kwargs)
    if inspect.isgenerator(result):
        result = list(result)
    return result


def _swallow_task_result(task: "asyncio.Task") -> None:
    """Consume a finished task's outcome without surfacing it anywhere."""
    try:
        if not task.cancelled():
            task.exception()
    except Exception:
        pass


def _next_or_done(it: Any) -> Any:
    try:
        return next(it)
    except StopIteration:
        return _STREAM_DONE


class UserCallableWrapper:
    """Builds and invokes the user callable (ref: replica.py:1017).

    Sync (non-async) callables and sync-generator pulls are dispatched to a
    per-replica thread executor: replica request handlers are asyncio tasks
    on one loop, and a blocking user callable executed inline would stall
    every concurrent request on the replica (ref: the reference runs sync
    user code through its own executor the same way).
    """

    def __init__(self, deployment_def: Any, init_args: tuple,
                 init_kwargs: Dict[str, Any], max_ongoing_requests: int = 0):
        self._is_class = inspect.isclass(deployment_def)
        if self._is_class:
            self._callable = deployment_def(*init_args, **init_kwargs)
        else:
            self._callable = deployment_def
        self._max_ongoing = int(max_ongoing_requests)
        self._pool = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # Sized to the replica's concurrency bound so max_ongoing sync
            # requests really overlap instead of queueing on the pool.
            self._pool = ThreadPoolExecutor(
                max_workers=max(8, self._max_ongoing),
                thread_name_prefix="serve-replica-sync")
        return self._pool

    def _target(self, method_name: str):
        if self._is_class:
            if method_name == "__call__":
                return self._callable
            return getattr(self._callable, method_name)
        return self._callable

    async def call(self, method_name: str, args: tuple, kwargs: dict) -> Any:
        target = self._target(method_name)
        if not _is_async_callable(target):
            return await run_in_executor(_invoke_sync_unary, target, args,
                                         kwargs, executor=self._executor())
        result = target(*args, **kwargs)
        if inspect.isawaitable(result):
            result = await result
        if hasattr(result, "__anext__"):  # unary endpoint: drain async gen
            return [item async for item in result]
        if inspect.isgenerator(result):  # unary endpoint: drain to a list
            result = list(result)
        return result

    async def call_streaming(self, method_name: str, args: tuple,
                             kwargs: dict):
        """Invoke WITHOUT draining; returns a sync or async iterator
        (ref: replica.py streaming via Ray streaming generators)."""
        target = self._target(method_name)
        if _is_async_callable(target):
            result = target(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
        else:
            # Creating a sync generator is lazy, but a plain sync function
            # may do real work before returning its iterator — off-loop.
            result = await run_in_executor(target, *args,
                                           executor=self._executor(),
                                           **kwargs)
        if inspect.isgenerator(result) or hasattr(result, "__anext__"):
            return result
        raise TypeError(
            f"streaming call to {method_name!r} did not return a generator "
            f"(got {type(result).__name__}); use a non-streaming handle")

    async def call_reconfigure(self, user_config: Any) -> None:
        if self._is_class and hasattr(self._callable, "reconfigure"):
            out = self._callable.reconfigure(user_config)
            if inspect.isawaitable(out):
                await out

    async def call_drain(self) -> None:
        """User-overridable drain hook: a deployment class may define
        on_drain() (sync or async), run once when the replica enters
        DRAINING, after in-flight requests finish and before teardown.
        Best-effort: a failing hook must never wedge the drain."""
        if not self._is_class or not hasattr(self._callable, "on_drain"):
            return
        fn = self._callable.on_drain
        try:
            if not _is_async_callable(fn):
                await run_in_executor(fn, executor=self._executor())
                return
            out = fn()
            if inspect.isawaitable(out):
                await out
        except Exception:
            pass

    async def call_prewarm(self, model_ids: list) -> int:
        """Pre-load multiplexed model ids through every @serve.multiplexed
        loader on the callable (warm-pool pre-start: promotion then skips
        the weights' load).  Returns the number of successful loads;
        failures are swallowed — prewarm is an optimization."""
        if not self._is_class or not model_ids:
            return 0
        loaders = []
        seen = set()
        for klass in type(self._callable).__mro__:
            for name, fn in vars(klass).items():
                if name in seen:
                    continue
                seen.add(name)
                if callable(fn) and hasattr(fn, "_multiplex_wrappers"):
                    loaders.append(fn)
        loaded = 0
        for fn in loaders:
            for model_id in model_ids:
                try:
                    out = fn(self._callable, model_id)
                    if inspect.isawaitable(out):
                        await out
                    loaded += 1
                except Exception:
                    pass
        return loaded

    async def call_health_check(self) -> None:
        """User-overridable probe: a deployment class may define
        check_health() (sync or async); raising marks the probe failed
        (ref: replica.py check_health / the deployment's user health
        check).  Sync checks run on the executor — a blocking probe must
        not stall the replica's event loop."""
        if self._is_class and hasattr(self._callable, "check_health"):
            fn = self._callable.check_health
            if not _is_async_callable(fn):
                await run_in_executor(fn, executor=self._executor())
                return
            out = fn()
            if inspect.isawaitable(out):
                await out


class ReplicaActor:
    """Async actor; concurrent requests bounded by the deployment's
    max_ongoing_requests via the actor's max_concurrency (ref: replica.py
    Replica — asyncio user code event loop)."""

    def __init__(self, deployment_name: str, replica_id: str,
                 deployment_def: Any, init_args: tuple,
                 init_kwargs: Dict[str, Any],
                 user_config: Any = None, max_ongoing_requests: int = 0):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._wrapper = UserCallableWrapper(
            deployment_def, init_args, init_kwargs or {},
            max_ongoing_requests=max_ongoing_requests)
        self._num_ongoing = 0
        self._num_processed = 0
        self._user_config = user_config
        self._multiplexed_model_ids: list = []
        self._streams: Dict[str, Any] = {}
        # Per-method (span attributes, metric tags) — invariant per method,
        # cached so the request hot path allocates neither dict.
        self._method_meta: Dict[str, tuple] = {}

    async def initialize_and_get_metadata(self) -> Dict[str, Any]:
        if self._user_config is not None:
            await self._wrapper.call_reconfigure(self._user_config)
        return {"replica_id": self.replica_id}

    # ------------------------------------------------------------- requests
    async def handle_request(self, method_name: str, *args, **kwargs) -> Any:
        mux_id = kwargs.pop("_serve_multiplexed_model_id", None)
        self._num_ongoing += 1
        t0 = time.time()
        meta = self._method_meta.get(method_name)
        if meta is None:
            meta = self._method_meta[method_name] = (
                {"deployment": self.deployment_name,
                 "replica": self.replica_id, "method": method_name},
                {"deployment": self.deployment_name, "method": method_name})
        span_attrs, metric_tags = meta
        try:
            self._set_replica_context()
            if mux_id:
                from ray_tpu_torch.serve import context as serve_context

                serve_context._set_request_model_id(mux_id)
            # Nests under the runtime's task-execute span (which carries
            # the submitter's trace context from the TaskSpec), so the
            # replica-side work joins the request's trace.
            with _tracing.span("serve.replica", attributes=span_attrs):
                return await self._wrapper.call(method_name, args, kwargs)
        finally:
            from ray_tpu_torch.serve import metrics as serve_metrics

            serve_metrics.EXECUTION.observe(
                time.time() - t0, tags=metric_tags,
                exemplar=serve_metrics.trace_exemplar())
            self._num_ongoing -= 1
            self._num_processed += 1

    # ---------------------------------------------------------- streaming
    # Pull protocol (ref: serve streaming responses over Ray streaming
    # generators).  The actor-streaming path is a push model the async
    # replica cannot host, so the router/handle PULLS items one actor call
    # at a time — natural backpressure, same ordering guarantees.

    #: Streams idle past this are reaped (client died without cancel — a
    #: kill -9'd remote driver would otherwise pin _num_ongoing forever).
    STREAM_IDLE_TIMEOUT_S = 300.0

    #: Max items shipped per pull: bounds the reply size when a producer
    #: banked a burst.
    STREAM_BATCH_MAX = 128

    def _set_replica_context(self) -> None:
        from ray_tpu_torch.serve import context as serve_context

        serve_context._set_internal_replica_context(
            deployment=self.deployment_name, replica_id=self.replica_id,
            replica=self)

    def _register_stream(self, it) -> str:
        import uuid as _uuid

        self._reap_idle_streams()
        sid = _uuid.uuid4().hex[:16]
        # [iterator, last-pull time, parked __anext__ task (async tier)]
        self._streams[sid] = [it, time.time(), None]
        self._num_ongoing += 1
        return sid

    def _reap_idle_streams(self) -> None:
        now = time.time()
        for sid, entry in list(self._streams.items()):
            if now - entry[1] > self.STREAM_IDLE_TIMEOUT_S:
                self._end_stream(sid)

    async def start_stream(self, method_name: str, *args, **kwargs) -> str:
        self._set_replica_context()
        mux_id = kwargs.pop("_serve_multiplexed_model_id", None)
        if mux_id:
            from ray_tpu_torch.serve import context as serve_context

            serve_context._set_request_model_id(mux_id)
        it = await self._wrapper.call_streaming(method_name, args, kwargs)
        return self._register_stream(it)

    async def next_stream(self, stream_id: str):
        """("item", value), ("items", [..]), ("items_done", [..]) or
        ("done", None); exceptions propagate and end the stream.  One pull
        blocks for the first item, then drains whatever the generator can
        yield WITHOUT suspending — a burst already buffered replica-side
        ships in one actor round-trip instead of one RPC per item.
        ("items_done", [..]) delivers a final burst and ends the stream in
        the same reply.  The replica context is (re)set per pull — the
        generator BODY executes during pulls, in a different task than
        start_stream's."""
        entry = self._streams.get(stream_id)
        if entry is None:
            raise ValueError(f"unknown or finished stream {stream_id}")
        entry[1] = time.time()
        it = entry[0]
        self._set_replica_context()
        try:
            if hasattr(it, "__anext__"):
                task, entry[2] = entry[2], None
                if task is None:
                    task = asyncio.ensure_future(it.__anext__())
                try:
                    first = await task
                except StopAsyncIteration:
                    self._end_stream(stream_id)
                    return ("done", None)
                items = [first]
                while len(items) < self.STREAM_BATCH_MAX:
                    nxt = asyncio.ensure_future(it.__anext__())
                    ready, _ = await asyncio.wait({nxt}, timeout=0)
                    if not ready:
                        # The generator suspended: park the in-flight
                        # __anext__ for the next pull — cancelling it here
                        # would throw into the generator body mid-await.
                        entry[2] = nxt
                        break
                    try:
                        items.append(nxt.result())
                    except StopAsyncIteration:
                        self._end_stream(stream_id)
                        return ("items_done", items)
                    except Exception:
                        # Ship what we have; the parked completed task
                        # re-raises on the next pull and ends the stream.
                        entry[2] = nxt
                        break
                if len(items) == 1:
                    return ("item", first)
                return ("items", items)
            # Sync iterator: its body executes during next() — pull on the
            # executor so a blocking generator cannot stall the loop's
            # other streams/requests.  Pulls are sequential per stream, so
            # the generator is never advanced from two threads at once.
            value = await run_in_executor(_next_or_done, it,
                                          executor=self._wrapper._executor())
            if value is _STREAM_DONE:
                self._end_stream(stream_id)
                return ("done", None)
            return ("item", value)
        except Exception:
            self._end_stream(stream_id)
            raise

    def cancel_stream(self, stream_id: str) -> None:
        self._end_stream(stream_id)

    def _end_stream(self, stream_id: str) -> None:
        entry = self._streams.pop(stream_id, None)
        if entry is None:
            return
        it = entry[0]
        pending = entry[2] if len(entry) > 2 else None
        if pending is not None:
            # A parked __anext__ survives the stream: cancel it if still in
            # flight (the cancel unwinds the generator before the aclose
            # below), and retrieve its result quietly so a stashed error
            # never logs as an un-retrieved task exception after the client
            # walked away.
            entry[2] = None
            if not pending.done():
                pending.cancel()
            pending.add_done_callback(_swallow_task_result)
        self._num_ongoing -= 1
        self._num_processed += 1
        if hasattr(it, "aclose"):
            # Async generators clean up via aclose(); schedule it on the
            # running loop when there is one (async tier), else best-effort.
            try:
                import asyncio as _aio

                try:
                    # detached_ok: best-effort generator cleanup, unawaited by design
                    _aio.get_running_loop().create_task(it.aclose())
                except RuntimeError:  # no running loop (sync tier)
                    _aio.run(it.aclose())
            except Exception:
                pass
            return
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    # ------------------------------------------------------------ control
    def get_num_ongoing_requests(self) -> int:
        """(ref: replica_scheduler queue-len probe RPC)"""
        return self._num_ongoing

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "deployment": self.deployment_name,
            "num_ongoing_requests": self._num_ongoing,
            "num_processed_requests": self._num_processed,
            "multiplexed_model_ids": list(self._multiplexed_model_ids),
        }

    def record_multiplexed_model_ids(self, model_ids: list) -> None:
        """Record loaded model ids locally AND forward them to the
        controller, which folds them into the replica-set long-poll push
        so routers can prefer warm replicas.  Fire-and-forget: metadata
        is an optimization, never worth failing a load/evict over."""
        self._multiplexed_model_ids = list(model_ids)
        try:
            import ray_tpu_torch
            from ray_tpu_torch.serve.api import _CONTROLLER_NAME

            controller = ray_tpu_torch.get_actor(_CONTROLLER_NAME)
            controller.record_multiplexed_model_ids.remote(
                self.replica_id, list(model_ids))
        except Exception:
            pass

    async def reconfigure(self, user_config: Any) -> None:
        self._user_config = user_config
        await self._wrapper.call_reconfigure(user_config)

    async def check_health(self) -> bool:
        await self._wrapper.call_health_check()
        return True

    async def prewarm(self, model_ids: list) -> int:
        """Warm-pool pre-start: load the given multiplexed model ids now so
        a later promotion into the serving set costs a state flip, not a
        weights' load."""
        self._set_replica_context()
        return await self._wrapper.call_prewarm(list(model_ids or []))

    async def prepare_for_shutdown(self, wait_loop_s: float = 5.0) -> None:
        """Drain: in-flight requests AND streams (both count in
        _num_ongoing) get wait_loop_s to finish, then the user callable's
        on_drain() hook runs;
        the controller hard-kills at graceful_shutdown_timeout_s regardless
        (ref: replica graceful shutdown loop)."""
        deadline = time.time() + wait_loop_s
        while self._num_ongoing > 0 and time.time() < deadline:
            await asyncio.sleep(0.02)
        self._set_replica_context()
        await self._wrapper.call_drain()
