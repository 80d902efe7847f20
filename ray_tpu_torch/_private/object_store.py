"""The object store: the in-process value tier and the serialized tier on the
host's shared-memory arena, with spilling (the counterpart of
``ray_tpu/_private/object_store.py``; ref: src/ray/core_worker/
store_provider/memory_store/memory_store.h:42, src/ray/object_manager/
plasma/store.h:55).

* Thread workers share the driver's address space, so a put stores the value
  itself: a reference, never a copy (a torch tensor on the GPU stays where it
  is).
* The serialized tier holds wire forms (``serialization.py``) in the native
  arena (``ray_tpu_torch/native/src/plasma.cc``: a shared mapping of one
  file under ``/dev/shm``, a boundary-tag allocator, LRU eviction), which
  the process workers attach. A process task's result lands here as its
  wire form; a value put by the driver gets one when something asks for it
  (``get_serialized``). A get deserializes a wire form from a private copy,
  so a freed object's block is reused at once; the reference deserializes
  in place and keeps every block so read until shutdown. The arena is
  built and created with the store: where it cannot be, the store raises
  with the compiler's or the OS's message (the reference falls back to
  ``multiprocessing.shared_memory``).
* Past ``object_spilling_threshold`` of the capacity, the least recently
  used wire forms are spilled to ``spill_dir`` (ref:
  raylet/local_object_manager.h:41) and restored on access.

The arena's file is ``torch_plasma_<pid>_<thread>_<seq>`` and the default
spill directory ``ray_tpu_torch_spill``: neither package's sweep of dead
arenas or spill files touches the other's.
"""

from __future__ import annotations

import atexit
import glob
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectID


class ObjectState:
    PENDING = "PENDING"
    READY = "READY"
    SPILLED = "SPILLED"
    FAILED = "FAILED"
    FREED = "FREED"


class _Entry:
    __slots__ = ("state", "value", "has_value", "error", "event", "in_plasma",
                 "exported", "spill_path", "size", "pinned", "last_access",
                 "owner")

    def __init__(self) -> None:
        self.state = ObjectState.PENDING
        self.value: Any = None
        self.has_value = False
        self.error: Optional[BaseException] = None
        # Lazy: most objects are put before anyone blocks on them; waiters
        # create it via _wait_entry.
        self.event: Optional[threading.Event] = None
        self.in_plasma = False
        #: Zero-copy views into the arena were handed out (deserialized
        #: arrays alias it): the entry is never spilled or recycled.
        self.exported = False
        self.spill_path: Optional[str] = None
        #: Bytes of the wire form, once there is one.
        self.size = 0
        self.pinned = 0
        self.last_access = 0.0
        self.owner = ""


_RESOLVED = (ObjectState.READY, ObjectState.SPILLED, ObjectState.FAILED)

_ARENA_SEQ = [0]
_ARENA_PATTERN = re.compile(r"torch_plasma_(\d+)_")


def _sweep_dead_arenas(roots=None) -> None:
    """Unlink the port's arena files left by processes that died without
    shutting down (the name embeds the owner's pid). Only names of the
    port's pattern are looked at: the reference's ``tpu_plasma_*`` files
    are its own sweep's."""
    from ray_tpu_torch.native.plasma import ARENA_PREFIX, arena_roots

    for root in roots or arena_roots():
        for path in glob.glob(os.path.join(root, ARENA_PREFIX + "*")):
            m = _ARENA_PATTERN.match(os.path.basename(path))
            if not m or int(m.group(1)) == os.getpid():
                continue
            try:
                os.kill(int(m.group(1)), 0)
            except ProcessLookupError:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            except PermissionError:
                pass  # alive under another uid


#: Least arena a store creates: its object table alone takes ~3.7 MB.
_MIN_ARENA = 64 << 20


def _unlink_quietly(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _make_arena(capacity_bytes: int):
    """Build the native library and create a fresh arena. The path carries
    pid, thread and a per-process sequence number, so two stores in one
    process never unlink each other's file; a store not shut down has its
    file unlinked when the interpreter exits."""
    from ray_tpu_torch.native.plasma import PlasmaClient, default_arena_path

    if _ARENA_SEQ[0] == 0:  # once per process
        _sweep_dead_arenas()
    _ARENA_SEQ[0] += 1
    path = default_arena_path(
        f"{os.getpid()}_{threading.get_native_id()}_{_ARENA_SEQ[0]}")
    _unlink_quietly(path)
    client = PlasmaClient(path, capacity=max(capacity_bytes, _MIN_ARENA),
                          create=True)
    atexit.register(_unlink_quietly, path)
    return client


class ObjectStore:
    def __init__(self, capacity_bytes: int = 0) -> None:
        self._entries: Dict[ObjectID, _Entry] = {}
        self._lock = threading.RLock()
        if capacity_bytes <= 0:
            try:
                capacity_bytes = int(os.sysconf("SC_PAGE_SIZE")
                                     * os.sysconf("SC_PHYS_PAGES") * 0.3)
            except (ValueError, OSError, AttributeError):
                capacity_bytes = 2 << 30
        #: The node's object memory (the ``memory`` resource): the serialized
        #: tier spills past ``object_spilling_threshold`` of it, and data
        #: pipelines size their in-flight byte budgets from it.
        self.capacity_bytes = capacity_bytes
        #: Wire-form bytes held in the arena.
        self._bytes_used = 0
        os.makedirs(GLOBAL_CONFIG.spill_dir, exist_ok=True)
        self.stats = {"puts": 0, "gets": 0, "spills": 0, "restores": 0,
                      "freed": 0}
        #: Freed objects whose arena bytes are still aliased by exported
        #: views: their creator reference is kept until shutdown.
        self._plasma_graveyard: Set[ObjectID] = set()
        self.plasma = _make_arena(capacity_bytes)

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

    @property
    def arena_path(self) -> Optional[str]:
        """Path process workers attach to for the arena's handoffs."""
        return self.plasma.path if self.plasma is not None else None

    # ------------------------------------------------------------------ puts
    def put(self, object_id: ObjectID, value: Any, owner: str = "") -> None:
        """Store a ready value by reference."""
        with self._lock:
            entry = self._entries.setdefault(object_id, _Entry())
            entry.value = value
            entry.has_value = True
            entry.state = ObjectState.READY
            entry.owner = owner
            entry.last_access = time.monotonic()
            self.stats["puts"] += 1
        self._signal(entry)

    def put_serialized(self, object_id: ObjectID, flat, owner: str = "") -> None:
        """Store an object already in wire form (a process worker's)."""
        with self._lock:
            entry = self._entries.setdefault(object_id, _Entry())
            self._attach_serialized(object_id, entry, flat)
            entry.state = ObjectState.READY
            entry.owner = owner
            entry.last_access = time.monotonic()
            self.stats["puts"] += 1
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
        """Byte size of a stored object: its wire form's where it has one,
        else what its value's type states (0 if unknown or absent)."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None or e.state not in (ObjectState.READY,
                                             ObjectState.SPILLED):
                return 0
            return e.size or _nbytes(e.value)

    def size_hint(self, object_id: ObjectID) -> int:
        """Best-effort byte size without serializing: the recorded size
        when known, else a cheap len/nbytes probe of the value."""
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return 0
            if e.size:
                return e.size
            if not e.has_value:
                return 0
            v = e.value
        return _nbytes(v)

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
        resolves every entry whose value is in the value tier; entries that
        need deserializing or a restore are materialized after it, and
        anything else (pending, failed, freed) is left to the caller's
        per-object slow path, which owns the error and reconstruction
        semantics."""
        n = len(object_ids)
        values: List[Any] = [None] * n
        missing: List[int] = []
        slow: List[int] = []
        now = time.monotonic()
        with self._lock:
            entries = self._entries
            for i in range(n):
                e = entries.get(object_ids[i])
                if e is not None and e.state == ObjectState.READY \
                        and e.has_value:
                    values[i] = e.value
                    e.last_access = now
                elif e is not None and e.state in (ObjectState.READY,
                                                   ObjectState.SPILLED):
                    slow.append(i)
                else:
                    missing.append(i)
            self.stats["gets"] += n - len(slow) - len(missing)
        for i in slow:
            oid = object_ids[i]
            with self._lock:
                e = self._entries.get(oid)
            if e is None:
                missing.append(i)
                continue
            try:
                values[i] = self._materialize(oid, e)
            except BaseException:  # noqa: BLE001 — lost or freed mid-batch
                missing.append(i)
        if slow and missing:
            missing.sort()
        return values, missing

    def _serialized_view(self, object_id: ObjectID, entry: _Entry,
                         export: bool = False) -> Optional[memoryview]:
        """The wire form's zero-copy view in the arena (caller holds the
        lock). ``export=True`` marks the entry as aliased by long-lived
        consumers (deserialized arrays), pinning it against spilling; a
        plain view is valid only until the next operation that may
        spill."""
        if entry.in_plasma and self.plasma is not None:
            view = self.plasma.get(object_id, timeout=0)
            if view is not None:
                # The store's own reference from create() keeps the object;
                # the get()'s is given back at once.
                self.plasma.release(object_id)
                if export:
                    entry.exported = True
                return view[: entry.size]
        return None

    def _materialize(self, object_id: ObjectID, entry: _Entry) -> Any:
        with self._lock:
            entry.last_access = time.monotonic()
            self.stats["gets"] += 1
            if entry.state == ObjectState.FAILED:
                raise entry.error  # type: ignore[misc]
            if entry.state == ObjectState.FREED:
                from ray_tpu_torch.exceptions import ObjectFreedError

                raise ObjectFreedError(f"Object {object_id} was freed")
            if entry.has_value:
                return entry.value
            view = self._serialized_view(object_id, entry)
            if view is not None:
                # From a private copy: a value aliasing the arena would pin
                # its block until shutdown (the reference's exported views),
                # and every process result is read so.
                value = serialization.deserialize_flat(
                    memoryview(bytearray(view)))
                view.release()
                entry.value, entry.has_value = value, True
                return value
            if entry.spill_path is not None:
                self.stats["restores"] += 1
                with open(entry.spill_path, "rb") as f:
                    flat = bytearray(f.read())
                value = serialization.deserialize_flat(memoryview(flat))
                entry.value, entry.has_value = value, True
                entry.state = ObjectState.READY
                return value
            from ray_tpu_torch.exceptions import ObjectLostError

            raise ObjectLostError(f"Object {object_id} has no value")

    def get_serialized(self, object_id: ObjectID,
                       timeout: Optional[float] = None) -> memoryview:
        """The wire form (arena-backed, zero-copy), serialized from the
        value on first request."""
        entry = self._ensure(object_id)
        if not self._wait_entry(entry, timeout):
            from ray_tpu_torch.exceptions import GetTimeoutError

            raise GetTimeoutError(f"Timed out getting object {object_id}")
        with self._lock:
            if entry.state == ObjectState.FAILED:
                raise entry.error  # type: ignore[misc]
            view = self._serialized_view(object_id, entry)
            if view is None and entry.spill_path is None:
                so = serialization.serialize(entry.value)
                if not self._attach_serialized_obj(object_id, entry, so):
                    self._attach_serialized(object_id, entry, so.to_bytes())
                view = self._serialized_view(object_id, entry)
            if view is not None:
                return view
            with open(entry.spill_path, "rb") as f:  # type: ignore[arg-type]
                return memoryview(f.read())

    # --------------------------------------------------------------- lifecycle
    def _ensure(self, object_id: ObjectID) -> _Entry:
        with self._lock:
            return self._entries.setdefault(object_id, _Entry())

    def _spill_path(self, object_id: ObjectID) -> str:
        return os.path.join(GLOBAL_CONFIG.spill_dir,
                            f"{object_id}.bin".replace(":", "_"))

    def _attach_serialized_obj(self, object_id: ObjectID, entry: _Entry,
                               so) -> bool:
        """Write a SerializedObject's wire form straight into a fresh arena
        buffer (no flat copy). Caller holds the lock. False where the
        arena cannot take it; the caller falls back to the flat path."""
        if self.plasma is None or entry.in_plasma:
            return False
        size = so.flat_size
        self._maybe_spill(size)
        if object_id in self._plasma_graveyard:
            return False
        try:
            buf = self.plasma.create(object_id, max(size, 1))
        except Exception:  # noqa: BLE001 — full or taken: the flat path
            return False
        try:
            so.write_into(buf)
        except BaseException:
            # A created-but-unsealed object would poison every later access
            # of this key: seal and delete it, or graveyard the key.
            buf.release()
            try:
                self.plasma.seal(object_id)
                self.plasma.release(object_id)
                if not self.plasma.delete(object_id):
                    self._plasma_graveyard.add(object_id)
            except Exception:  # noqa: BLE001
                self._plasma_graveyard.add(object_id)
            raise
        buf.release()
        self.plasma.seal(object_id)
        self._bytes_used += size
        entry.in_plasma = True
        entry.size = size
        return True

    def _attach_serialized(self, object_id: ObjectID, entry: _Entry,
                           flat) -> None:
        from ray_tpu_torch.native.plasma import PlasmaObjectExists

        size = len(flat)
        self._maybe_spill(size)
        if self.plasma is not None:
            try:
                buf = self.plasma.create(object_id, max(size, 1))
                buf[:size] = flat
                buf.release()
                self.plasma.seal(object_id)
                self._bytes_used += size
                entry.in_plasma = True
                entry.size = size
                return
            except PlasmaObjectExists:
                if object_id not in self._plasma_graveyard:
                    # A duplicate delivery of the same bytes (a task retry):
                    # the first create's accounting and reference stand.
                    if not entry.in_plasma:
                        self._bytes_used += size
                    entry.in_plasma = True
                    entry.size = size
                    return
                # A freed object still aliased by views holds this key: its
                # bytes are stale for a re-created id; go to disk instead.
            except MemoryError:
                pass  # full even after eviction: to disk below
        path = self._spill_path(object_id)
        with open(path, "wb") as f:
            f.write(flat)
        entry.spill_path = path
        entry.size = size

    def _maybe_spill(self, incoming: int) -> None:
        """LRU-spill wire forms to disk while the arena is past the
        threshold (caller holds the lock). Exported entries are skipped:
        spilling them would recycle memory under live views."""
        threshold = self.capacity_bytes * GLOBAL_CONFIG.object_spilling_threshold
        if self._bytes_used + incoming <= threshold:
            return
        candidates = sorted(
            ((e.last_access, oid, e) for oid, e in self._entries.items()
             if not e.pinned and e.in_plasma and not e.exported),
            key=lambda c: c[0])
        for _, oid, entry in candidates:
            if self._bytes_used + incoming <= threshold:
                break
            view = self._serialized_view(oid, entry)
            if view is None:
                continue
            path = self._spill_path(oid)
            with open(path, "wb") as f:
                f.write(view)
            view.release()
            del view
            self._release_serialized(oid, entry)
            entry.spill_path = path
            if not entry.has_value:
                entry.state = ObjectState.SPILLED
            self.stats["spills"] += 1

    def _release_serialized(self, object_id: ObjectID, entry: _Entry) -> None:
        if not (entry.in_plasma and self.plasma is not None):
            return
        self._bytes_used -= entry.size
        if entry.exported:
            # Views into the arena may be alive in user code: keep the
            # creator reference so neither delete nor eviction recycles the
            # block; reclaimed when the arena is unlinked at shutdown.
            self._plasma_graveyard.add(object_id)
        else:
            self.plasma.release(object_id)  # the creator's reference
            self.plasma.delete(object_id)
        entry.in_plasma = False
        entry.exported = False

    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            self._ensure(object_id).pinned += 1

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e:
                e.pinned = max(0, e.pinned - 1)

    def free(self, object_id: ObjectID) -> None:
        """Called when the reference count hits zero."""
        with self._lock:
            entry = self._entries.pop(object_id, None)
            if entry is None:
                return
            if self.plasma is not None:
                self._release_serialized(object_id, entry)
            if entry.spill_path:
                try:
                    os.unlink(entry.spill_path)
                except OSError:
                    pass
            entry.state = ObjectState.FREED
            entry.value = None
            self.stats["freed"] += 1
        self._signal(entry)

    def evict_value(self, object_id: ObjectID) -> None:
        """Drop the deserialized copy, keep the wire form."""
        with self._lock:
            e = self._entries.get(object_id)
            if e and (e.in_plasma or e.spill_path):
                e.value, e.has_value = None, False
                if not e.in_plasma:
                    e.state = ObjectState.SPILLED

    def bytes_used(self) -> int:
        """Bytes held: each READY or spilled object's wire form where it has
        one, else what its value's type states (arrays, tensors, byte
        strings; the value tier keeps references, so other values count
        0)."""
        with self._lock:
            return sum(e.size or _nbytes(e.value)
                       for e in self._entries.values()
                       if e.state in (ObjectState.READY, ObjectState.SPILLED))

    def usage(self) -> Tuple[int, int]:
        """(wire-form bytes in the arena, capacity)."""
        with self._lock:
            return self._bytes_used, self.capacity_bytes

    def object_summaries(self) -> List[dict]:
        """Per-object view for the state API and the metrics agent (ref:
        `ray list objects`); ``size`` as ``size_of`` counts it."""
        with self._lock:
            return [{"object_id": str(oid), "state": e.state,
                     "size": (e.size or _nbytes(e.value))
                     if e.state in (ObjectState.READY, ObjectState.SPILLED)
                     else 0,
                     "pinned": e.pinned, "owner": e.owner,
                     "in_plasma": e.in_plasma,
                     "spilled": e.spill_path is not None}
                    for oid, e in self._entries.items()]

    def shutdown(self) -> None:
        """Drop every entry, remove the spill files and unlink the arena.
        Close waits for arena calls in flight on other threads."""
        with self._lock:
            # Detach the table first: dropping values can run ObjectRef
            # finalizers that re-enter free() on this thread (RLock).
            entries, self._entries = self._entries, {}
            plasma, self.plasma = self.plasma, None
            self._plasma_graveyard.clear()
        for entry in entries.values():
            if entry.spill_path:
                try:
                    os.unlink(entry.spill_path)
                except OSError:
                    pass
        if plasma is not None:
            plasma.close(unlink=True)


def _nbytes(value: Any) -> int:
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    n = getattr(value, "nbytes", None)  # numpy arrays, tensors, data blocks
    return n if isinstance(n, int) else 0
