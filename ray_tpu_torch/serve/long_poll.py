"""Long-poll config push: controller → routers/proxies (the counterpart of
``ray_tpu/serve/long_poll.py``).

(ref: python/ray/serve/_private/long_poll.py — LongPollHost:204 holds
(snapshot_id, object) per key and parks listeners until a key changes;
LongPollClient:66 re-issues listen calls and invokes callbacks.)
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, Dict, Tuple

from ray_tpu_torch._private.runtime import get_runtime, runtime_or_none


class LongPollHost:
    """Lives inside the controller actor's event loop."""

    def __init__(self) -> None:
        self._snapshots: Dict[str, Tuple[int, Any]] = {}
        self._events: Dict[str, asyncio.Event] = {}

    def _event(self, key: str) -> asyncio.Event:
        ev = self._events.get(key)
        if ev is None:
            ev = self._events[key] = asyncio.Event()
        return ev

    def notify_changed(self, updates: Dict[str, Any]) -> None:
        """(ref: long_poll.py LongPollHost.notify_changed)"""
        for key, value in updates.items():
            sid, _ = self._snapshots.get(key, (0, None))
            self._snapshots[key] = (sid + 1, value)
            ev = self._event(key)
            ev.set()
            self._events[key] = asyncio.Event()  # fresh event for next round

    async def listen_for_change(self, keys_to_snapshot_ids: Dict[str, int],
                                timeout_s: float = 30.0) -> Dict[str, Tuple[int, Any]]:
        """Return keys whose snapshot advanced past the client's; park until
        one does (ref: LongPollHost.listen_for_change)."""
        out = {
            key: self._snapshots[key]
            for key, sid in keys_to_snapshot_ids.items()
            if key in self._snapshots and self._snapshots[key][0] > sid
        }
        if out:
            return out
        waiters = [self._event(key) for key in keys_to_snapshot_ids]
        done, pending = set(), []
        try:
            tasks = [asyncio.ensure_future(w.wait()) for w in waiters]
            done, pending_set = await asyncio.wait(
                tasks, timeout=timeout_s, return_when=asyncio.FIRST_COMPLETED)
            pending = list(pending_set)
        finally:
            for t in pending:
                t.cancel()
        return {
            key: self._snapshots[key]
            for key, sid in keys_to_snapshot_ids.items()
            if key in self._snapshots and self._snapshots[key][0] > sid
        }


class LongPollClient:
    """Driver/proxy-side poller: a daemon thread re-issuing listen calls on
    the controller handle (ref: long_poll.py LongPollClient)."""

    def __init__(self, controller_handle, key_callbacks: Dict[str, Callable[[Any], None]]):
        self._controller = controller_handle
        #: The runtime the controller lives in: once it is shut down (or
        #: replaced), the controller is gone and the client stops.
        self._runtime = get_runtime()
        self._callbacks = dict(key_callbacks)
        self._snapshot_ids: Dict[str, int] = {k: 0 for k in key_callbacks}
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-long-poll")
        self._thread.start()

    def _loop(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ActorDiedError

        while not self._stopped.is_set():
            if runtime_or_none() is not self._runtime:
                self._stopped.set()
                return
            try:
                updates = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        dict(self._snapshot_ids), 1.0),
                    timeout=10.0)
            except ActorDiedError:
                # Controller is gone (serve.shutdown) — no point retrying.
                self._stopped.set()
                return
            except Exception:
                if self._stopped.is_set():
                    return
                self._stopped.wait(0.2)
                continue
            for key, (sid, value) in (updates or {}).items():
                self._snapshot_ids[key] = sid
                try:
                    self._callbacks[key](value)
                except Exception:
                    pass

    def stop(self) -> None:
        self._stopped.set()
