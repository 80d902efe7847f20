"""DeploymentHandle — the data-plane API for calling deployments (the
counterpart of ``ray_tpu/serve/handle.py``).

(ref: python/ray/serve/handle.py — DeploymentHandle:625 returning
DeploymentResponse futures; composition passes handles between deployments,
requests go straight handle → replica, never through the controller.)
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Dict, Optional


class DeploymentResponse:
    """Future-like result of handle.remote() (ref: handle.py
    DeploymentResponse — .result(), awaitable).

    Retries on replica death: during a rolling update the router's cached
    replica set lags the controller, so a request can land on a replica torn
    down moments later — the reference's router re-assigns such requests.
    """

    def __init__(self, ref, retry=None):
        self._ref = ref
        self._retry = retry

    def result(self, timeout_s: Optional[float] = None) -> Any:
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ActorDiedError, TaskError

        attempts = 3 if self._retry is not None else 1
        for attempt in range(attempts):
            try:
                return ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except ActorDiedError:
                if attempt == attempts - 1:
                    raise
                import time

                time.sleep(0.2 * (attempt + 1))  # let the long-poll catch up
                self._ref = self._retry()
            except TaskError as e:
                from ray_tpu_torch.serve.exceptions import BackPressureError

                # A DOWNSTREAM deployment shed this request (composition:
                # an inner handle call hit capacity).  Surface the
                # BackPressureError itself, not a generic task failure, so
                # callers/proxies can shed gracefully (503) instead of
                # reporting an internal error.
                if isinstance(getattr(e, "cause", None), BackPressureError):
                    raise e.cause from None
                raise

    def __await__(self):
        from ray_tpu_torch._private import runtime as _rt

        return _rt.get_runtime().get_async(self._ref).__await__()

    @property
    def object_ref(self):
        """Escape hatch to the underlying ObjectRef (ref:
        DeploymentResponse._to_object_ref)."""
        return self._ref


_reaper_lock = threading.Lock()
_reaper: Optional["queue.SimpleQueue"] = None  # guarded_by: _reaper_lock


def _reap_queue() -> "queue.SimpleQueue":
    """The queue of the daemon thread that cancels streams their consumer
    abandoned (started with the first stream, not at import). The thread
    is free to block, so it resolves a stream id no pull resolved yet and
    waits for the replica to end the stream."""
    global _reaper
    with _reaper_lock:
        if _reaper is None:
            _reaper = queue.SimpleQueue()
            threading.Thread(target=_reap_loop, args=(_reaper,), daemon=True,
                             name="serve-stream-reaper").start()
        return _reaper


def _reap_loop(q: "queue.SimpleQueue") -> None:
    while True:
        gen = q.get()
        try:
            gen.cancel(wait=True)
        except Exception:  # the reaper must outlive one bad stream
            traceback.print_exc()
        del gen


class DeploymentResponseGenerator:
    """Streaming result of handle.options(stream=True).remote(...)
    (ref: handle.py DeploymentResponseGenerator): iterate sync or async;
    each pull drains everything the pinned replica's generator can yield
    without suspending (one RPC per burst, not per item), buffered locally
    between pulls.  The stream id is an ObjectRef resolved lazily at the
    first pull, so creating the generator never blocks (safe inside async
    replicas)."""

    def __init__(self, replica_actor, stream_id_ref, on_done=None):
        from collections import deque

        self._actor = replica_actor
        self._sid_ref = stream_id_ref
        self._sid: Optional[str] = None
        self._on_done = on_done
        self._finished = False
        #: Locally-buffered burst from a batched pull: the replica ships
        #: every item its generator can yield without suspending in ONE
        #: actor round-trip (("items", [..]) / ("items_done", [..])), and
        #: iteration drains this buffer before the next RPC.
        self._buf = deque()
        #: The REPLICA ended the stream (done marker, or an exception the
        #: replica raised — it reaps its slot on those).  A local abort
        #: (pull timeout, task cancellation, consumer bailing) leaves the
        #: replica holding the slot, and cancel() must still fire even
        #: though iteration already marked _finished.
        self._server_done = False
        self._reaper = _reap_queue()
        from ray_tpu_torch._private import runtime as _rt

        #: The runtime the stream lives in: a cancel that runs after it shut
        #: down sends nothing (and starts no other runtime).
        self._runtime = _rt.runtime_or_none()

    def _finish(self, exc: Optional[BaseException] = None) -> None:
        if not self._finished:
            self._finished = True
            if self._on_done is not None:
                self._on_done(exc)

    def _resolve_sid(self) -> str:
        if self._sid is None:
            import ray_tpu_torch

            self._sid = ray_tpu_torch.get(self._sid_ref, timeout=30.0)
        return self._sid

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch

        if self._buf:
            return self._buf.popleft()
        if self._finished:
            raise StopIteration
        try:
            kind, value = ray_tpu_torch.get(
                self._actor.next_stream.remote(self._resolve_sid()))
        except BaseException as e:
            # A replica-raised error ended the stream server-side; local
            # failures (timeout/cancel) did NOT — cancel() handles those.
            from ray_tpu_torch.exceptions import TaskError

            if isinstance(e, TaskError):
                self._server_done = True
            self._finish(e)
            raise
        return self._accept(kind, value, StopIteration)

    def __aiter__(self):
        return self

    async def __anext__(self):
        from ray_tpu_torch._private import runtime as _rt

        if self._buf:
            return self._buf.popleft()
        if self._finished:
            raise StopAsyncIteration
        try:
            rt = _rt.get_runtime()
            if self._sid is None:
                self._sid = await rt.get_async(self._sid_ref)
            kind, value = await rt.get_async(
                self._actor.next_stream.remote(self._sid))
        except BaseException as e:
            from ray_tpu_torch.exceptions import TaskError

            if isinstance(e, TaskError):
                self._server_done = True
            self._finish(e)
            raise
        return self._accept(kind, value, StopAsyncIteration)

    def _accept(self, kind: str, value: Any, stop: type):
        """Fold one pull reply into iteration state and return the next
        item (or raise ``stop``)."""
        if kind == "done":
            self._server_done = True
            self._finish()
            raise stop
        if kind == "item":
            return value
        # "items" / "items_done": a replica-side burst in one round-trip.
        self._buf.extend(value)
        if kind == "items_done":
            # Stream ended server-side with this burst; iteration keeps
            # draining the local buffer, then stops without another RPC.
            self._server_done = True
            self._finish()
        return self._buf.popleft()

    def cancel(self, wait: bool = True) -> None:
        """Release the replica-side iterator.  Fires whenever the REPLICA
        has not already ended the stream — including after a local abort
        already marked iteration finished (a wedged pull or client
        disconnect must not pin the replica's slot for the idle timeout).
        ``wait=False`` fire-and-forgets, and sends nothing while no pull
        has resolved the stream id: a caller that must not block hands the
        stream to ``abandon`` instead."""
        from ray_tpu_torch._private import runtime as _rt

        if self._server_done:
            return
        self._server_done = True  # one cancel is enough (it is idempotent)
        rt = self._runtime
        try:
            if rt is _rt.runtime_or_none():
                if self._sid is None and wait:
                    self._sid = rt.get(self._sid_ref, timeout=30.0)
                if self._sid is not None:
                    ref = self._actor.cancel_stream.remote(self._sid)
                    if wait:
                        rt.get(ref, timeout=10.0)
        except Exception:
            pass
        self._finish()

    def abandon(self) -> None:
        """Cancel the replica-side stream without blocking the caller: the
        reaper thread resolves the stream id if need be and cancels."""
        if not self._server_done:
            self._reaper.put(self)

    def __del__(self):
        # The garbage collector may run this inside any critical section
        # of this thread (the refcount table, the router's scheduler, a
        # metric), so the cancel — which takes those locks — runs on the
        # reaper thread instead. SimpleQueue.put is safe here.
        self.abandon()


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str,
                 controller_handle=None, method_name: str = "__call__"):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._controller = controller_handle
        self._router = None
        self._router_lock = threading.Lock()
        self._stream = False
        self._multiplexed_model_id = ""

    @property
    def deployment_id(self) -> str:
        return f"{self.app_name}#{self.deployment_name}"

    def _get_router(self):
        # Lazy: handles are pickled into replicas for composition; the router
        # (threads, long-poll) must be constructed in the consuming process.
        with self._router_lock:
            if self._router is None:
                from ray_tpu_torch.serve.api import _get_controller
                from ray_tpu_torch.serve.router import Router

                controller = self._controller or _get_controller()
                self._router = Router(controller, self.deployment_id)
            return self._router

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        # Materialize the router BEFORE sharing: if the child built it, the
        # parent's _router would stay None and a duplicate Router (extra
        # long-poll + metrics threads, split queue accounting) would follow.
        self._get_router()
        h = DeploymentHandle(self.deployment_name, self.app_name,
                             self._controller,
                             method_name or self._method_name)
        h._router = self._router
        h._router_lock = self._router_lock
        h._stream = self._stream if stream is None else bool(stream)
        h._multiplexed_model_id = (self._multiplexed_model_id
                                   if multiplexed_model_id is None
                                   else multiplexed_model_id)
        return h

    def remote(self, *args, **kwargs):
        # Dirty read first: once built, the router never changes, and the
        # lock would serialize every caller thread on the hot path.
        router = self._router
        if router is None:
            router = self._get_router()
        method = self._method_name
        if self._multiplexed_model_id:
            # Rides to the router (warm-replica preference) and on to the
            # replica (request context for @serve.multiplexed loaders).
            kwargs.setdefault("_serve_multiplexed_model_id",
                              self._multiplexed_model_id)
        if self._stream:
            # Streaming (ref: handle.options(stream=True) → a generator of
            # results): every item is pulled from the pinned replica.
            actor, sid, done = router.assign_stream(method, *args, **kwargs)
            return DeploymentResponseGenerator(actor, sid, done)

        # Compiled steady-state route: when the replica set is stable the
        # router has lowered dispatch onto pre-resolved channels — no
        # TaskSpec, no ObjectRef.  None means the route is dynamic (or a
        # teardown raced us); fall through to the classic path.
        compiled = router.try_assign_compiled(method, *args, **kwargs)
        if compiled is not None:
            return compiled

        def assign():
            return router.assign_request(method, *args, **kwargs)

        return DeploymentResponse(assign(), retry=assign)

    # pickling: drop the live router; rebuilt lazily on the other side
    def __getstate__(self) -> Dict[str, Any]:
        return {"deployment_name": self.deployment_name,
                "app_name": self.app_name, "_method_name": self._method_name,
                "_stream": self._stream,
                "_multiplexed_model_id": self._multiplexed_model_id}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.deployment_name = state["deployment_name"]
        self.app_name = state["app_name"]
        self._method_name = state["_method_name"]
        self._controller = None
        self._router = None
        self._router_lock = threading.Lock()
        self._stream = state.get("_stream", False)
        self._multiplexed_model_id = state.get("_multiplexed_model_id", "")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def __repr__(self) -> str:
        return f"DeploymentHandle({self.deployment_id!r})"
