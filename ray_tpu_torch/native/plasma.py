"""ctypes binding for the port's shared-memory object arena (the counterpart
of ``ray_tpu/native/plasma.py``).

The C++ side (src/plasma.cc) owns allocation, the object table, locking and
LRU eviction; this binding hashes ids to the fixed 20-byte wire form,
exposes payloads as zero-copy memoryviews over one long-lived mmap of the
arena, and composes create+seal / get as ``put_bytes`` / ``get_bytes``.

Equivalent of the reference's plasma client (ref: src/ray/object_manager/
plasma/client.h) minus the socket protocol: clients attach the arena file
directly.

Two things differ from ``ray_tpu``'s client:

* A call in flight never meets a freed handle. Every call counts itself in
  and out; ``close()`` marks the client closed (new calls raise
  ``ConnectionError``), wakes the calls blocked in a ``get`` through the
  arena's condvar (they raise ``ConnectionError`` too), waits until none is
  in flight, and only then unmaps the arena and frees the handle.
* The file is sized with ``ftruncate`` and mapped shared, so a write past
  what its filesystem can hold would be a SIGBUS rather than an error: a
  creating client clamps its capacity to the filesystem's free space and
  logs that it did.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import mmap
import os
import tempfile
import threading
from typing import Optional, Tuple

from ray_tpu_torch.native.build import plasma_library

logger = logging.getLogger(__name__)

ID_LEN = 20

#: Arena files of this package start with this; the reference's start with
#: ``tpu_plasma_``, so neither package's sweep touches the other's files.
ARENA_PREFIX = "torch_plasma_"


class PlasmaOOMError(MemoryError):
    """Create failed even after LRU eviction — caller should spill to disk."""


class PlasmaObjectExists(ValueError):
    pass


def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(plasma_library(), use_errno=True)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tps_connect.restype = ctypes.c_void_p
    lib.tps_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint32, ctypes.c_int]
    lib.tps_disconnect.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p]
    lib.tps_interrupt.argtypes = [ctypes.c_void_p]
    lib.tps_create.restype = ctypes.c_int
    lib.tps_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64, u64p]
    lib.tps_seal.restype = ctypes.c_int
    lib.tps_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_unseal.restype = ctypes.c_int
    lib.tps_unseal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_get.restype = ctypes.c_int
    lib.tps_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                            u64p, u64p]
    lib.tps_release.restype = ctypes.c_int
    lib.tps_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_delete.restype = ctypes.c_int
    lib.tps_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_contains.restype = ctypes.c_int
    lib.tps_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_evict.restype = ctypes.c_uint64
    lib.tps_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tps_usage.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
    lib.tps_refcount.restype = ctypes.c_int64
    lib.tps_refcount.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _get_lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _lib()
        return _LIB


def object_key(object_id) -> bytes:
    """20-byte wire id from any hashable id (ObjectID, str, bytes)."""
    if isinstance(object_id, bytes) and len(object_id) == ID_LEN:
        return object_id
    raw = object_id if isinstance(object_id, bytes) else str(object_id).encode()
    return hashlib.sha1(raw).digest()


def arena_roots() -> Tuple[str, ...]:
    """Where arenas live: ``/dev/shm`` where the host has it (memory, not
    disk), else the temporary directory."""
    roots = [tempfile.gettempdir()]
    if os.path.isdir("/dev/shm"):
        roots.insert(0, "/dev/shm")
    return tuple(roots)


def default_arena_path(session_name: str) -> str:
    return os.path.join(arena_roots()[0], f"{ARENA_PREFIX}{session_name}")


def free_bytes(path: str) -> int:
    """Free bytes of the filesystem that holds ``path``'s directory."""
    st = os.statvfs(os.path.dirname(os.path.abspath(path)))
    return st.f_bavail * st.f_frsize


def clamp_capacity(path: str, capacity: int) -> int:
    """``capacity``, or the free space of ``path``'s filesystem rounded down
    to a page where that is less (a sparse arena written past it would
    fault)."""
    free = free_bytes(path)
    if capacity <= free:
        return capacity
    clamped = free // mmap.PAGESIZE * mmap.PAGESIZE
    logger.warning("plasma arena %s: capacity %d clamped to the %d bytes "
                   "free on its filesystem", path, capacity, clamped)
    return clamped


class PlasmaClient:
    """One per process. The creating process passes create=True and owns the
    arena file's lifetime; workers attach with create=False."""

    def __init__(self, path: str, capacity: int = 0, *, create: bool,
                 max_entries: int = 1 << 16) -> None:
        self._lib = _get_lib()
        self.path = path
        self._owner = create
        self._h = None
        self._calls = threading.Condition(threading.Lock())
        self._inflight = 0
        self._closed = False
        if create:
            capacity = clamp_capacity(path, capacity if capacity > 0
                                      else 1 << 30)
        h = self._lib.tps_connect(path.encode(), capacity, max_entries,
                                  int(create))
        if not h:
            err = ctypes.get_errno()
            raise OSError(err, f"plasma connect failed (path={path}, "
                               f"create={create}, capacity={capacity}): "
                               f"{os.strerror(err) if err else 'bad arena'}")
        self._h = h
        self._fd = os.open(path, os.O_RDWR)
        size = os.fstat(self._fd).st_size
        self._map = mmap.mmap(self._fd, size)
        self._view = memoryview(self._map)
        #: Bytes the arena file spans (the capacity, after any clamp).
        self.capacity = size

    # ------------------------------------------------------------ call guard
    def _enter(self):
        with self._calls:
            if self._closed:
                raise ConnectionError("plasma client is closed")
            self._inflight += 1
            return self._h

    def _leave(self) -> None:
        with self._calls:
            self._inflight -= 1
            if not self._inflight:
                self._calls.notify_all()

    def _call(self, fn, *args):
        h = self._enter()
        try:
            return fn(h, *args)
        finally:
            self._leave()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------- lifecycle
    def create(self, object_id, size: int) -> memoryview:
        """Allocate a writable buffer; write into it, then seal()."""
        off = ctypes.c_uint64()
        rc = self._call(self._lib.tps_create, object_key(object_id), size,
                        ctypes.byref(off))
        if rc == -1:
            raise PlasmaObjectExists(f"{object_id} already in store")
        if rc == -2:
            raise PlasmaOOMError(f"no space for {size} bytes (after eviction)")
        if rc == -3:
            raise PlasmaOOMError("object table full")
        return self._view[off.value: off.value + size]

    def seal(self, object_id) -> None:
        if self._call(self._lib.tps_seal, object_key(object_id)) != 0:
            raise ValueError(f"seal failed for {object_id}")

    def unseal(self, object_id) -> None:
        """Reopen for in-place mutation (compiled-graph channels)."""
        if self._call(self._lib.tps_unseal, object_key(object_id)) != 0:
            raise ValueError(f"unseal failed for {object_id}")

    def get_region(self, object_id, timeout: Optional[float] = None
                   ) -> Optional[Tuple[int, int]]:
        """(arena offset, size) of a sealed object; increments its refcount
        (release() when done). None on timeout; timeout=None blocks until
        the object is sealed or the client is closed (ConnectionError)."""
        off, size = ctypes.c_uint64(), ctypes.c_uint64()
        tmo = -1 if timeout is None else max(0, int(timeout * 1000))
        rc = self._call(self._lib.tps_get, object_key(object_id), tmo,
                        ctypes.byref(off), ctypes.byref(size))
        if rc == -4:
            raise ConnectionError("plasma client closed during get")
        if rc != 0:
            return None
        return off.value, size.value

    def get(self, object_id, timeout: Optional[float] = None
            ) -> Optional[memoryview]:
        """Zero-copy view of a sealed object; increments its refcount.
        None on timeout. timeout=None blocks forever; 0 polls."""
        region = self.get_region(object_id, timeout)
        if region is None:
            return None
        return self._view[region[0]: region[0] + region[1]]

    def release(self, object_id) -> None:
        self._call(self._lib.tps_release, object_key(object_id))

    def delete(self, object_id) -> bool:
        return self._call(self._lib.tps_delete, object_key(object_id)) == 0

    def contains(self, object_id) -> bool:
        return bool(self._call(self._lib.tps_contains, object_key(object_id)))

    def refcount(self, object_id) -> int:
        return int(self._call(self._lib.tps_refcount, object_key(object_id)))

    def evict(self, nbytes: int) -> int:
        return int(self._call(self._lib.tps_evict, nbytes))

    def usage(self) -> Tuple[int, int, int]:
        used, cap, objs = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        self._call(self._lib.tps_usage, ctypes.byref(used), ctypes.byref(cap),
                   ctypes.byref(objs))
        return used.value, cap.value, objs.value

    # ------------------------------------------------------------ composites
    def put_bytes(self, object_id, data) -> None:
        buf = self.create(object_id, len(data))
        buf[:] = data
        buf.release()
        self.seal(object_id)

    def get_bytes(self, object_id, timeout: Optional[float] = None
                  ) -> Optional[bytes]:
        view = self.get(object_id, timeout)
        if view is None:
            return None
        try:
            return bytes(view)
        finally:
            view.release()
            self.release(object_id)

    def close(self, unlink: bool = False) -> None:
        """Refuse new calls, wake the blocked ones, wait for every call in
        flight, then unmap and free the handle (and unlink the file if this
        client created it and ``unlink``)."""
        with self._calls:
            if self._closed:
                return
            self._closed = True
            h = self._h
            while self._inflight:
                self._lib.tps_interrupt(h)
                self._calls.wait(0.05)
            self._h = None
        try:
            self._view.release()
            self._map.close()
        except BufferError:
            pass  # zero-copy views still alive: the mapping stays until GC
        try:
            os.close(self._fd)
        except OSError:
            pass
        self._lib.tps_disconnect(h, int(unlink and self._owner),
                                 self.path.encode())

    def __del__(self) -> None:
        try:
            if self._h is not None:
                self.close()
        except Exception:
            pass
