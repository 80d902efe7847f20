"""Typed channels for compiled graphs (the counterpart of
``ray_tpu/dag/channel.py:1-221``; ref: python/ray/experimental/channel/ —
intra_process_channel.py, torch_tensor_nccl_channel.py).

A compiled DAG edge is a bounded single-producer single-consumer pipe with a
type-driven transport:

- ``Channel`` / ``IntraProcessChannel`` — an in-process bounded queue between
  actor threads: handing a value over is a pointer move.
- ``DeviceChannel`` — every ``torch.Tensor`` of an element is placed on the
  consumer's device at write time (``.to(device, non_blocking=True)``); a
  tensor already there passes as is, with no copy. The edge is ordered
  across CUDA streams: the write records an event on the producer's current
  stream, and the read makes the consumer's current stream wait on it.

- ``SharedMemoryChannel`` — an edge with a process worker at either end,
  over the object store's shared-memory arena (``native/plasma.py``): one
  sealed arena object per element, written by the producer's process and
  deleted by the consumer's as it reads. It pickles by the arena's path.
  The element is pickled with the port's serializer, so a CUDA tensor leaf
  crosses as a host copy (a d2h transfer at the writer) and lands on the
  card of the reader's lease (an h2d transfer at the reader); a CPU tensor
  stays on the CPU.

The reference's channels between worker nodes (``NodeLocalChannel``,
``RemoteChannel``) need the object server and real nodes (ROADMAP.md, Queue
1 item 13.8b).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, List, Optional


class ChannelClosed(Exception):
    """Raised on read/write after close() — the teardown signal."""


class ChannelTimeout(Exception):
    pass


class Channel:
    """Bounded SPSC/MPMC in-process channel (ref: intra_process_channel.py).

    ``slot_width`` > 0 additionally gives the channel a ring of reusable
    pre-sized record buffers (plain fixed-width lists): producers
    ``acquire_slot()``, fill the fields in place, and ``write()`` the slot;
    consumers hand it back with ``release_slot()`` once the payload is dead.
    In steady state the ring converges to the channel's high-water mark of
    in-flight slots and per-send allocation drops to zero —
    ``slot_allocations`` exposes the grow count so tests can assert the
    no-alloc property."""

    def __init__(self, maxsize: int = 16, name: str = "", slot_width: int = 0):
        self.name = name
        self._maxsize = max(1, maxsize)
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._slot_width = int(slot_width)
        self._free_slots: deque = deque()
        self._slot_allocations = 0

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        with self._not_full:
            while len(self._buf) >= self._maxsize and not self._closed:
                if not self._not_full.wait(timeout=timeout):
                    raise ChannelTimeout(f"write timeout on channel {self.name!r}")
            if self._closed:
                raise ChannelClosed(self.name)
            self._buf.append(self._transform(value))
            self._not_empty.notify()

    def read(self, timeout: Optional[float] = None) -> Any:
        with self._not_empty:
            while not self._buf:
                if self._closed:
                    raise ChannelClosed(self.name)
                if not self._not_empty.wait(timeout=timeout):
                    raise ChannelTimeout(f"read timeout on channel {self.name!r}")
            value = self._buf.popleft()
            self._not_full.notify()
            return value

    def read_ready(self, max_n: int, out: Optional[list] = None) -> list:
        """Drain up to ``max_n`` buffered elements without blocking (never
        raises on a closed channel — buffered elements stay readable after
        close, matching read()).  Appends into ``out`` when given so a
        steady-state consumer can reuse one scratch list."""
        batch = [] if out is None else out
        with self._not_empty:
            n = min(int(max_n), len(self._buf))
            for _ in range(n):
                batch.append(self._buf.popleft())
            if n:
                self._not_full.notify()
        return batch

    # ------------------------------------------------------------- slot ring
    def acquire_slot(self) -> list:
        """A pre-sized record buffer from the reuse ring (grows on demand;
        steady state recycles without allocating)."""
        with self._lock:
            if self._free_slots:
                return self._free_slots.popleft()
            self._slot_allocations += 1
        return [None] * self._slot_width

    def release_slot(self, slot: list) -> None:
        """Return a slot to the ring.  Fields are cleared first so pooled
        slots never pin payloads/futures across requests."""
        for i in range(len(slot)):
            slot[i] = None
        with self._lock:
            self._free_slots.append(slot)

    @property
    def slot_allocations(self) -> int:
        """How many slots were ever allocated (ring growth counter)."""
        return self._slot_allocations

    @property
    def closed(self) -> bool:
        """Dirty read for poll-style consumers; buffered elements remain
        readable (via read()/read_ready()) even when True."""
        return self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def _transform(self, value: Any) -> Any:
        return value


IntraProcessChannel = Channel


def _telemetry():
    """The device-telemetry plane iff loaded (the cross-layer probe idiom:
    no channel import pulls it in)."""
    return sys.modules.get("ray_tpu_torch.util.device_telemetry")


def _nbytes(t) -> int:
    return int(t.element_size()) * int(t.numel())


class _Placed:
    """One element of a :class:`DeviceChannel` as it waits in the buffer:
    the value with its tensors on the consumer's device, the CUDA event the
    consumer must wait on (recorded on the producer's stream after the
    copies were issued), and the tensor bytes the ``dag_channel`` pool was
    charged at write, which the read releases."""

    __slots__ = ("value", "event", "stream", "cuda", "d2h", "nbytes")

    def __init__(self, value, event, stream, cuda, d2h, nbytes):
        self.value = value
        self.event = event
        self.stream = stream
        self.cuda = cuda
        self.d2h = d2h
        self.nbytes = nbytes


class DeviceChannel(Channel):
    """Channel whose elements are placed on the consumer's device at write
    time (ref: torch_tensor_nccl_channel.py).  Dicts, lists and tuples are
    walked; every ``torch.Tensor`` leaf moves with ``.to(device,
    non_blocking=True)``, and one already on ``device`` passes as is.

    ``device`` None passes elements through untouched.  The telemetry plane
    sees the edge's tensor bytes in its ``dag_channel`` pool while they wait
    in the buffer, and a transfer only where bytes cross the host boundary
    (``h2d`` or ``d2h``): a copy between cards, or none, is not one."""

    def __init__(self, device=None, maxsize: int = 16, name: str = "",
                 payload_index: Optional[int] = None):
        super().__init__(maxsize=maxsize, name=name)
        if device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self._device = device
        #: Record-style edges (serve pipeline: ``(payload, future, ctx)``)
        #: set this so only the payload field crosses devices.
        self._payload_index = payload_index

    def _move(self, value: Any) -> _Placed:
        import torch

        dev = self._device
        cuda: List[Any] = []
        crossed = {"h2d": 0, "d2h": 0}
        sources: List[Any] = []
        nbytes = 0

        def walk(v):
            nonlocal nbytes
            if isinstance(v, torch.Tensor):
                nbytes += _nbytes(v)
                if v.device != dev:
                    if v.is_cuda:
                        sources.append(v.device)
                    if v.is_cuda != (dev.type == "cuda"):
                        crossed["h2d" if dev.type == "cuda" else "d2h"] += \
                            _nbytes(v)
                    v = v.to(dev, non_blocking=True)
                if v.is_cuda:
                    cuda.append(v)
                return v
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, list):
                return [walk(x) for x in v]
            if isinstance(v, tuple):
                items = [walk(x) for x in v]
                return (type(v)(*items) if hasattr(v, "_fields")
                        else tuple(items))
            return v

        out = walk(value)
        event = stream = None
        d2h = bool(crossed["d2h"])
        if cuda or d2h:
            # After the copies were issued: the consumer's stream (or, for a
            # copy to the host, the consumer's thread) orders after both
            # the producer's work and the copy.
            stream = torch.cuda.current_stream(
                cuda[0].device if cuda else sources[0])
            event = torch.cuda.Event()
            event.record(stream)
        dt = _telemetry()
        if dt is None:
            nbytes = 0  # nothing charged, so the read releases nothing
        else:
            for direction, n in crossed.items():
                if n:
                    dt.record_transfer(direction, n, src="dag_channel")
            if nbytes:
                dt.pool_add("dag_channel", nbytes)
        return _Placed(out, event, stream, cuda, d2h, nbytes)

    def _transform(self, value: Any) -> Any:
        if self._device is None:
            return value
        if self._payload_index is None:
            return self._move(value)
        record = list(value)
        placed = self._move(record[self._payload_index])
        record[self._payload_index] = placed
        return record

    # ------------------------------------------------------- the read side
    def read(self, timeout: Optional[float] = None) -> Any:
        return self._take(super().read(timeout=timeout))

    def read_ready(self, max_n: int, out: Optional[list] = None) -> list:
        start = 0 if out is None else len(out)
        batch = super().read_ready(max_n, out)
        for i in range(start, len(batch)):
            batch[i] = self._take(batch[i])
        return batch

    def _take(self, element: Any) -> Any:
        if self._device is None:
            return element
        if self._payload_index is None:
            return self._unplace(element)
        element[self._payload_index] = self._unplace(
            element[self._payload_index])
        return element

    def _unplace(self, placed: _Placed) -> Any:
        """The consumer's side: order this thread's stream after the
        producer's event (a host copy waits on the host), keep the tensors'
        memory until that stream is done with them, and release the pool."""
        if placed.event is not None:
            import torch

            if placed.d2h:
                placed.event.synchronize()
            if placed.cuda:
                cur = torch.cuda.current_stream(placed.cuda[0].device)
                if cur != placed.stream:
                    cur.wait_event(placed.event)
                    for t in placed.cuda:
                        t.record_stream(cur)
        if placed.nbytes:
            dt = _telemetry()
            if dt is not None:
                dt.pool_sub("dag_channel", placed.nbytes)
        return placed.value

    def drain(self) -> int:
        """Read and drop what is still buffered (after teardown, so the
        ``dag_channel`` pool releases unread elements); returns how many."""
        return len(self.read_ready(1 << 30))


# ------------------------------------------------------ across processes
#: Arena clients of this process by path: a channel that crossed to another
#: process pickled only its path, and attaches there on first use.
_ARENA_CLIENTS: dict = {}
_ARENA_LOCK = threading.Lock()

#: This process's shared-memory channel traffic: elements written and read,
#: their wire-form bytes, and the seconds spent writing (serializing, a CUDA
#: leaf's copy to the host, the copy into the arena) and reading (the copy
#: out, deserializing, a leaf's copy to the card), waits for the other side
#: left out.
CHANNEL_STATS = {"writes": 0, "reads": 0, "bytes_written": 0,
                 "bytes_read": 0, "write_s": 0.0, "read_s": 0.0}


def seed_arena_client(path: str, client) -> None:
    """Register an existing client (the object store's, a worker's) so the
    channels of this process reuse it instead of mapping the arena again."""
    with _ARENA_LOCK:
        cached = _ARENA_CLIENTS.get(path)
        if cached is None or cached.closed:
            _ARENA_CLIENTS[path] = client


def _arena_for(path: str):
    with _ARENA_LOCK:
        client = _ARENA_CLIENTS.get(path)
        if client is None or client.closed:
            # None, or a client an earlier runtime of this process closed
            # (arena paths repeat by pid across init and shutdown).
            from ray_tpu_torch.native.plasma import PlasmaClient

            client = _ARENA_CLIENTS[path] = PlasmaClient(path, create=False)
        return client


def _reader_device():
    """Where a CUDA tensor leaf lands for the calling reader: the card of
    its task's lease (an actor's loop, in the driver or a worker), none
    for a task without cards, else (the driver) the current card; None
    where there is no card."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    from ray_tpu_torch._private.runtime import current_task_context

    ctx = current_task_context()
    if ctx is None:
        return torch.device("cuda", torch.cuda.current_device())
    if not ctx.gpu_ids:
        return None
    from ray_tpu_torch._private.device import local_gpu_index

    return torch.device("cuda", local_gpu_index(ctx.gpu_ids[0]))


class SharedMemoryChannel:
    """Cross-process channel over the shared-memory arena (ref:
    shared_memory_channel.py): element ``n`` is the sealed arena object
    ``<name>:<n>``; the reader waits for the next one with the arena's
    blocking get, copies it out and deletes it. The writer runs at most
    ``maxsize`` elements ahead of the reader.

    Picklable: only the arena's path travels, and each process attaches its
    own client on first use. ``close()`` seals ``<name>:__closed__`` so the
    other side's reads and writes see the teardown; elements already
    written stay readable until the channel is empty. ``reclaim()`` deletes
    what is left once both ends are done. Writes from several threads of
    one process (a serve lane's callers) take turns under a lock, and so do
    reads: two writers racing on the sequence number would skip or reuse
    one, and the reader would wait forever (the reference has no lock)."""

    def __init__(self, arena=None, name: str = "", maxsize: int = 16,
                 arena_path: Optional[str] = None):
        self._arena_obj = arena
        self._arena_path = arena_path or getattr(arena, "path", None)
        if self._arena_obj is None and not self._arena_path:
            raise ValueError("SharedMemoryChannel needs an arena or its path")
        self.name = name
        self._maxsize = max(1, maxsize)
        self._wseq = 0
        self._rseq = 0
        self._closed = False
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()

    @property
    def _arena(self):
        if self._arena_obj is None:
            self._arena_obj = _arena_for(self._arena_path)
        return self._arena_obj

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_arena_obj"] = None  # attached by path on the other side
        del state["_wlock"], state["_rlock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()

    def _peer_closed(self) -> bool:
        try:
            return self._arena.contains(f"{self.name}:__closed__")
        except ConnectionError:
            return True

    def _oldest_live(self) -> int:
        # The reader deletes what it consumed: probe on from the last floor.
        while self._rseq < self._wseq and not self._arena.contains(
                f"{self.name}:{self._rseq}"):
            self._rseq += 1
        return self._rseq

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        with self._wlock:
            self._write(value, timeout)

    def _write(self, value: Any, timeout: Optional[float]) -> None:
        from ray_tpu_torch._private import serialization

        if self._closed or self._peer_closed():
            raise ChannelClosed(self.name)
        t0 = time.perf_counter()
        so = serialization.serialize(value)
        spent = time.perf_counter() - t0
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while self._wseq - self._oldest_live() >= self._maxsize:
                if deadline is not None and time.monotonic() > deadline:
                    raise ChannelTimeout(
                        f"write timeout on shm channel {self.name!r}")
                if self._closed or self._peer_closed():
                    raise ChannelClosed(self.name)
                time.sleep(0.0005)
            t0 = time.perf_counter()
            arena = self._arena
            key = f"{self.name}:{self._wseq}"
            size = so.flat_size
            buf = arena.create(key, size)
            try:
                so.write_into(buf)
            except BaseException:
                buf.release()
                arena.seal(key)
                arena.release(key)
                arena.delete(key)
                raise
            buf.release()
            arena.seal(key)
        except ConnectionError as e:  # the arena closed under us
            raise ChannelClosed(self.name) from e
        self._wseq += 1
        CHANNEL_STATS["writes"] += 1
        CHANNEL_STATS["bytes_written"] += size
        CHANNEL_STATS["write_s"] += spent + time.perf_counter() - t0
        if so.d2h_bytes:
            dt = _telemetry()
            if dt is not None:
                dt.record_transfer("d2h", so.d2h_bytes, src="dag_channel")

    def read(self, timeout: Optional[float] = None) -> Any:
        with self._rlock:
            return self._read(timeout)

    def _read(self, timeout: Optional[float]) -> Any:
        from ray_tpu_torch._private import serialization

        deadline = None if timeout is None else time.monotonic() + timeout
        key = f"{self.name}:{self._rseq}"
        try:
            arena = self._arena
            while True:
                slice_s = 0.25
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise ChannelTimeout(
                            f"read timeout on shm channel {self.name!r}")
                    slice_s = min(slice_s, left)
                view = arena.get(key, timeout=slice_s)
                if view is not None:
                    t0 = time.perf_counter()
                    break
                if self._closed or self._peer_closed():
                    raise ChannelClosed(self.name)
            try:
                data = bytearray(view)
            finally:
                view.release()
                arena.release(key)
            arena.release(key)  # the writer's reference from create()
            arena.delete(key)
        except ConnectionError as e:
            raise ChannelClosed(self.name) from e
        self._rseq += 1
        CHANNEL_STATS["reads"] += 1
        CHANNEL_STATS["bytes_read"] += len(data)
        value, h2d = serialization.deserialize_landing(memoryview(data),
                                                       _reader_device)
        if h2d:
            dt = _telemetry()
            if dt is not None:
                dt.record_transfer("h2d", h2d, src="dag_channel")
        CHANNEL_STATS["read_s"] += time.perf_counter() - t0
        return value

    def close(self) -> None:
        self._closed = True
        try:
            if not self._peer_closed():
                self._arena.put_bytes(f"{self.name}:__closed__", b"1")
        except Exception:  # noqa: BLE001 — a closed arena: nothing to tell
            pass

    def reclaim(self, drop_sentinel: bool = True) -> None:
        """Delete this channel's arena objects: unread elements, and the
        close sentinel with ``drop_sentinel`` (a straggling end still needs
        it to see the close). Called at teardown, after the loops joined.
        Probes on from this side's consumed floor with a miss tolerance,
        since consumed elements leave holes."""
        def drop(key: str) -> bool:
            try:
                if not self._arena.contains(key):
                    return False
                self._arena.release(key)
                self._arena.delete(key)
                return True
            except Exception:  # noqa: BLE001 — a closed arena holds nothing
                return False

        misses, k = 0, max(0, self._rseq)
        budget = max(256, 8 * self._maxsize)
        while misses < budget:
            if drop(f"{self.name}:{k}"):
                misses = 0
            else:
                misses += 1
            k += 1
        if drop_sentinel:
            drop(f"{self.name}:__closed__")
