"""ActorPool: load-balance tasks over a fixed set of actors (the
counterpart of ``ray_tpu/util/actor_pool.py``; ref:
python/ray/util/actor_pool.py ActorPool)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class ActorPool:
    """Tasks are dispatched to idle actors; excess submissions queue and
    drain as actors free up.  Results come back ordered (``get_next``/
    ``map``) or in completion order (``get_next_unordered``/
    ``map_unordered``)."""

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor: dict = {}   # ref -> (index, actor)
        self._index_to_future: dict = {}   # submission index -> ref
        self._pending: List[tuple] = []    # (fn, value) waiting for an actor
        self._next_task_index = 0
        self._next_return_index = 0

    # ------------------------------------------------------------ map APIs
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        """Lazily yield ordered results; `fn(actor, value)` returns an
        ObjectRef.  Results stream as the pipeline drains — nothing is
        eagerly ray_tpu_torch.get()'d up front."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        """Results in completion order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ------------------------------------------------------- submit/get APIs
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        if self._idle:
            self._dispatch(fn, self._idle.pop(), value)
        else:
            self._pending.append((fn, value))

    def _dispatch(self, fn, actor, value) -> None:
        ref = fn(actor, value)
        i = self._next_task_index
        self._next_task_index += 1
        self._future_to_actor[ref] = (i, actor)
        self._index_to_future[i] = ref

    def _free(self, actor) -> None:
        if self._pending:
            fn, value = self._pending.pop(0)
            self._dispatch(fn, actor, value)
        else:
            self._idle.append(actor)

    def has_next(self) -> bool:
        return bool(self._index_to_future or self._pending)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order (ref: ActorPool.get_next)."""
        # Skip indices already consumed by get_next_unordered.
        while (self._next_return_index < self._next_task_index
               and self._next_return_index not in self._index_to_future):
            self._next_return_index += 1
        if self._next_return_index not in self._index_to_future:
            if self._pending:
                # Tasks queued but nothing in flight and no idle actor to
                # dispatch to (actors were pop_idle()'d away) — deadlock,
                # not end-of-stream.
                raise RuntimeError(
                    f"{len(self._pending)} submitted task(s) can never run: "
                    "the pool has no in-flight work and no idle actors")
            raise StopIteration("no pending results")
        ref = self._index_to_future[self._next_return_index]
        ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next timed out")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        _, actor = self._future_to_actor.pop(ref)
        # Free BEFORE get: a raising task must still return its actor to the
        # pool (ref: Ray's ActorPool does the same).
        self._free(actor)
        return ray_tpu_torch.get(ref)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        if not self._future_to_actor:
            if self._pending:
                raise RuntimeError(
                    f"{len(self._pending)} submitted task(s) can never run: "
                    "the pool has no in-flight work and no idle actors")
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        i, actor = self._future_to_actor.pop(ref)
        del self._index_to_future[i]
        self._free(actor)
        return ray_tpu_torch.get(ref)

    def push(self, actor: Any) -> None:
        """Add an actor to the pool (ref: ActorPool.push)."""
        self._free(actor)

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
