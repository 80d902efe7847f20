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

The reference's cross-process channels over the shared-memory arena
(``SharedMemoryChannel``, ``NodeLocalChannel``, ``RemoteChannel``) are not
ported yet (ROADMAP.md, Queue 1 item 11b-2).
"""

from __future__ import annotations

import sys
import threading
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
