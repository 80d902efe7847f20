"""ObjectRef — a future handle with reference counting (the counterpart of
``ray_tpu/_private/object_ref.py``; ref: python/ray/includes/object_ref.pxi
and src/ray/core_worker/reference_count.h:66).

Each ref release (GC or explicit) decrements the process-local count; when
it reaches zero the runtime frees the store entry and drops the lineage.
A ref that crosses to a process worker is pickled as its id, and the driver
keeps it alive while the worker may use it (``client_runtime.py``); there
is no owner address and no borrowing protocol across nodes (they come with
the multi-node runtime, ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
from typing import Any

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner", "_released", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: str = "",
                 _add_ref: bool = True):
        self.id = ObjectID(object_id)
        self.owner = owner
        self._released = False
        if _add_ref:
            _refcounter.add(self.id)

    def __reduce__(self):
        # A copy made by pickle registers its own count (the default slot
        # protocol would build a clone that never adds but does remove).
        return (ObjectRef, (str(self.id), self.owner))

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self):
        return self.id.task_id()

    def _release(self) -> None:
        if not self._released:
            self._released = True
            _refcounter.release_from_finalizer(self.id)

    def __del__(self) -> None:
        try:
            self._release()
        except Exception:
            pass

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self) -> str:
        return f"ObjectRef({self.id})"

    # Allow `await ref` inside async actors / drivers.
    def __await__(self):
        from ray_tpu_torch._private.runtime import get_runtime

        return get_runtime().get_async(self).__await__()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        from ray_tpu_torch._private.runtime import get_runtime

        return get_runtime().as_future(self)


class ReferenceCounter:
    """Process-local refcount table. On zero, the registered callback runs
    (the runtime frees the object and its lineage).

    Handles are released by their finalizer (``ObjectRef.__del__``), which
    the garbage collector can run at any allocation, on any thread, also
    inside this class's own critical sections: a finalizer that blocked on
    the lock there would wait for itself. So a finalizer only tries the
    lock, and when it is taken leaves the release on a queue that the next
    call holding the lock applies."""

    def __init__(self) -> None:
        self._counts: dict = {}
        self._lock = threading.Lock()
        self._zero_callback = None
        #: Releases that found the lock taken. SimpleQueue.put is safe to
        #: call from a finalizer (it is reentrant).
        self._deferred: "queue.SimpleQueue" = queue.SimpleQueue()

    def set_zero_callback(self, cb) -> None:
        self._zero_callback = cb

    def add(self, object_id: ObjectID, n: int = 1) -> None:
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + n
        self._apply_deferred()

    def add_many(self, object_ids) -> None:
        """One lock round-trip for a batch of new handles."""
        with self._lock:
            counts = self._counts
            for oid in object_ids:
                counts[oid] = counts.get(oid, 0) + 1
        self._apply_deferred()

    def release_from_finalizer(self, object_id: ObjectID) -> None:
        """Drops one handle's count; never waits for the lock."""
        if not self._lock.acquire(blocking=False):
            self._deferred.put(object_id)
            return
        try:
            zero = self._decrement_locked(object_id)
        finally:
            self._lock.release()
        self._on_zero(object_id, zero)

    def _decrement_locked(self, object_id: ObjectID) -> bool:
        count = self._counts.get(object_id, 0) - 1
        if count <= 0:
            self._counts.pop(object_id, None)
            return True
        self._counts[object_id] = count
        return False

    def _on_zero(self, object_id: ObjectID, zero: bool) -> None:
        cb = self._zero_callback
        if zero and cb is not None:
            cb(object_id)

    def _apply_deferred(self) -> None:
        while True:
            try:
                object_id = self._deferred.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                zero = self._decrement_locked(object_id)
            self._on_zero(object_id, zero)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            while True:
                try:
                    self._deferred.get_nowait()
                except queue.Empty:
                    break


_refcounter = ReferenceCounter()


def global_refcounter() -> ReferenceCounter:
    return _refcounter
