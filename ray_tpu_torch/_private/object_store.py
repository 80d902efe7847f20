"""The in-process object store of the thread tier (the counterpart of
``ray_tpu/_private/object_store.py``'s value tier; ref: src/ray/core_worker/
store_provider/memory_store/memory_store.h:42).

Thread workers share the driver's address space, so an entry holds the
value itself: a put stores a reference, never a copy (a torch tensor on the
GPU stays where it is). Process workers send their values through their
pipe (``process_pool.py``); the serialized tier (the shared-memory arena,
spilling to disk) is not ported yet (ROADMAP.md, Queue 1 item 13.8).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID


class ObjectState:
    PENDING = "PENDING"
    READY = "READY"
    FAILED = "FAILED"
    FREED = "FREED"


class _Entry:
    __slots__ = ("state", "value", "error", "event")

    def __init__(self) -> None:
        self.state = ObjectState.PENDING
        self.value: Any = None
        self.error: Optional[BaseException] = None
        # Lazy: most objects are put before anyone blocks on them; waiters
        # create it via _wait_entry.
        self.event: Optional[threading.Event] = None


_RESOLVED = (ObjectState.READY, ObjectState.FAILED)


class ObjectStore:
    def __init__(self, capacity_bytes: int = 0) -> None:
        self._entries: Dict[ObjectID, _Entry] = {}
        self._lock = threading.RLock()
        #: The node's object memory (the ``memory`` resource), which data
        #: pipelines size their in-flight byte budgets from.
        self.capacity_bytes = capacity_bytes

    def _signal(self, entry: _Entry) -> None:
        """Wake waiters after a state transition (made under the lock; a
        waiter either saw the new state or had already published its
        event)."""
        ev = entry.event
        if ev is not None:
            ev.set()

    def _wait_entry(self, entry: _Entry, timeout: Optional[float]) -> bool:
        """Block until the entry leaves PENDING (True) or timeout (False)."""
        ev = entry.event
        if ev is None:
            with self._lock:
                if entry.state != ObjectState.PENDING:
                    return True
                ev = entry.event
                if ev is None:
                    ev = entry.event = threading.Event()
        return ev.wait(timeout)

    # ------------------------------------------------------------------ puts
    def put(self, object_id: ObjectID, value: Any) -> None:
        """Store a ready value by reference."""
        with self._lock:
            entry = self._entries.setdefault(object_id, _Entry())
            entry.value = value
            entry.state = ObjectState.READY
        self._signal(entry)

    def put_error(self, object_id: ObjectID, error: BaseException) -> None:
        with self._lock:
            entry = self._entries.setdefault(object_id, _Entry())
            entry.error = error
            entry.state = ObjectState.FAILED
        self._signal(entry)

    # ------------------------------------------------------------------ gets
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.state in _RESOLVED

    def contains_many(self, object_ids) -> List[bool]:
        """One lock pass over a batch."""
        with self._lock:
            entries = self._entries
            return [(e := entries.get(oid)) is not None and e.state in _RESOLVED
                    for oid in object_ids]

    def state_of(self, object_id: ObjectID) -> Optional[str]:
        """Entry state without creating an entry (None = never seen)."""
        with self._lock:
            e = self._entries.get(object_id)
            return e.state if e is not None else None

    def size_of(self, object_id: ObjectID) -> int:
        """Byte size of a READY value whose size its type states (0 if
        unknown or absent; see ``bytes_used``)."""
        with self._lock:
            e = self._entries.get(object_id)
            return _nbytes(e.value) if e is not None and \
                e.state == ObjectState.READY else 0

    def wait_ready(self, object_id: ObjectID, timeout: Optional[float]) -> bool:
        return self._wait_entry(self._ensure(object_id), timeout)

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        """Blocking get of the value; raises stored errors."""
        entry = self._ensure(object_id)
        if not self._wait_entry(entry, timeout):
            from ray_tpu_torch.exceptions import GetTimeoutError

            raise GetTimeoutError(f"Timed out getting object {object_id}")
        return self._materialize(object_id, entry)

    def try_get_many(self, object_ids) -> Tuple[List[Any], List[int]]:
        """Non-blocking get: ``(values, missing_indexes)``. One lock pass
        resolves every ready entry; anything else (pending, failed, freed)
        is left to the caller's per-object slow path, which owns the error
        and reconstruction semantics."""
        n = len(object_ids)
        values: List[Any] = [None] * n
        missing: List[int] = []
        with self._lock:
            entries = self._entries
            for i in range(n):
                e = entries.get(object_ids[i])
                if e is not None and e.state == ObjectState.READY:
                    values[i] = e.value
                else:
                    missing.append(i)
        return values, missing

    def _materialize(self, object_id: ObjectID, entry: _Entry) -> Any:
        with self._lock:
            if entry.state == ObjectState.FAILED:
                raise entry.error  # type: ignore[misc]
            if entry.state == ObjectState.FREED:
                from ray_tpu_torch.exceptions import ObjectFreedError

                raise ObjectFreedError(f"Object {object_id} was freed")
            return entry.value

    # --------------------------------------------------------------- lifecycle
    def _ensure(self, object_id: ObjectID) -> _Entry:
        with self._lock:
            return self._entries.setdefault(object_id, _Entry())

    def free(self, object_id: ObjectID) -> None:
        """Called when the reference count hits zero."""
        with self._lock:
            entry = self._entries.pop(object_id, None)
            if entry is None:
                return
            entry.state = ObjectState.FREED
            entry.value = None
        self._signal(entry)

    def bytes_used(self) -> int:
        """Bytes held by READY values whose size their type states (arrays,
        tensors, byte strings): the store keeps references, so other
        values count 0."""
        with self._lock:
            return sum(_nbytes(e.value) for e in self._entries.values()
                       if e.state == ObjectState.READY)

    def object_summaries(self) -> List[dict]:
        """Per-object view for the state API and the metrics agent (ref:
        `ray list objects`); ``size`` as ``size_of`` counts it."""
        with self._lock:
            return [{"object_id": str(oid), "state": e.state,
                     "size": _nbytes(e.value)
                     if e.state == ObjectState.READY else 0}
                    for oid, e in self._entries.items()]

    def shutdown(self) -> None:
        with self._lock:
            # Detach the table first: dropping values can run ObjectRef
            # finalizers that re-enter free() on this thread (RLock).
            self._entries = {}


def _nbytes(value: Any) -> int:
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    n = getattr(value, "nbytes", None)  # numpy arrays, tensors, data blocks
    return n if isinstance(n, int) else 0
