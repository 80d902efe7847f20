"""Unique identifiers for jobs, tasks, actors, objects and nodes (the
counterpart of ``ray_tpu/_private/ids.py``; ref: src/ray/common/id.h).

IDs are hex strings: an 8-byte per-process prefix drawn once from
``os.urandom`` and a monotonic counter, so drawing one costs no syscall.
An ObjectID is ``<task id>:<index>`` so the creating task is recoverable
from the object id alone (lineage reconstruction).
"""

from __future__ import annotations

import itertools
import os
import threading

_PROC_PREFIX = os.urandom(8).hex()
_id_counter = itertools.count(1)


def _next_id_hex() -> str:
    return f"{_PROC_PREFIX}{next(_id_counter):08x}"


class BaseID(str):
    """IDs are interned hex strings; cheap to hash and compare."""

    __slots__ = ()

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_next_id_hex())

    def hex(self) -> str:  # type: ignore[override]
        return str(self)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({str(self)})"


class JobID(BaseID):
    __slots__ = ()


class NodeID(BaseID):
    __slots__ = ()


class WorkerID(BaseID):
    __slots__ = ()


class ActorID(BaseID):
    __slots__ = ()


class TaskID(BaseID):
    __slots__ = ()


class PlacementGroupID(BaseID):
    __slots__ = ()


class ObjectID(BaseID):
    """``<task-part>:<index>`` — created by task ``task-part`` as its
    ``index``-th output."""

    __slots__ = ()

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(f"{task_id}:{index}")

    @classmethod
    def from_put(cls, put_counter: int, worker_part: str) -> "ObjectID":
        return cls(f"put-{worker_part}:{put_counter}")

    def task_id(self) -> TaskID:
        return TaskID(str(self).rsplit(":", 1)[0])


class _Counter:
    """Monotonic per-process counter used for put ids."""

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value


put_counter = _Counter()
