"""FIFO queue backed by an actor (the counterpart of
``ray_tpu/util/queue.py``; ref: python/ray/util/queue.py Queue — an
actor-hosted asyncio.Queue).

Its handle pickles, so process-tier train workers report through it."""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        from collections import deque

        self._maxsize = maxsize
        self._items: deque = deque()

    def qsize(self) -> int:
        return len(self._items)

    def put_nowait(self, item) -> bool:
        if self._maxsize > 0 and len(self._items) >= self._maxsize:
            return False
        self._items.append(item)
        return True

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self._maxsize > 0 and len(self._items) + len(items) > self._maxsize:
            return False
        self._items.extend(items)
        return True

    def get_nowait(self):
        if not self._items:
            return False, None
        return True, self._items.popleft()

    def get_nowait_batch(self, n: int):
        got = []
        while self._items and len(got) < n:
            got.append(self._items.popleft())
        return got


class Queue:
    """(ref: util/queue.py Queue).  Poll-based blocking: callers retry the
    actor's nowait ops until the deadline — no driver-side locks, any number
    of producer/consumer tasks or actors can share the handle."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = actor_options or {}
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() > deadline:
                raise Full
            time.sleep(0.005)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() > deadline:
                raise Empty
            time.sleep(0.005)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
