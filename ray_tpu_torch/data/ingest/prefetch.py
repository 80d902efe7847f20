"""Batch prefetch: host-side buffering + double-buffered device transfer
(the counterpart of ``ray_tpu/data/ingest/prefetch.py``).

Two stages, independently optional:

* :class:`HostPrefetcher` — a background thread pulls batches out of the
  (backpressured) ingest pipeline into a bounded queue so block fetch /
  shuffle / rebatch latency overlaps the training step.  Occupancy and
  starved-seconds are exported as metrics: occupancy pinned at 0 plus a
  growing starved counter is the "input-bound" signature.
* :class:`DeviceBatchIterator` — starts the host-to-device copy of batch
  N+1 before the caller steps on batch N.  The reference dispatches
  ``jax.device_put``, which returns at once; here each numeric column is
  staged in a pinned host buffer and copied with ``non_blocking=True`` on a
  side stream, an event marks the copy's end, and the consumer's stream
  waits on that event when the batch is handed out, so the copy overlaps
  the step on the batch before.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.data.ingest import metrics as ingest_metrics
from ray_tpu_torch.exceptions import WorkerCrashedError
from ray_tpu_torch.util import tracing

_END = ("end", None)


def _profiler_record(bucket: str, start: float, end: float) -> None:
    """Attribute an interval to the train step profiler when one is active
    on this thread (the consumer side of the pipeline IS the train worker
    thread).  Probed via sys.modules — the data layer must not import the
    train package (trainer -> collective import chain), and if the
    profiler module was never imported, none can be active."""
    mod = sys.modules.get("ray_tpu_torch.train.profiler")
    if mod is not None:
        mod.record(bucket, start, end)


class HostPrefetcher:
    """Pull ``src`` on a daemon thread into a queue of ``depth`` batches.

    Errors from the pipeline propagate to the consumer at the point they
    occurred in the stream (never silently truncate an epoch); ``close()``
    releases the pump thread even when the consumer abandons the iterator
    mid-epoch (elastic stop, grow boundary).
    """

    def __init__(self, src: Iterable[Any], depth: int = 2,
                 should_stop=None):
        # ``_q`` and ``_stop`` are the only pump<->consumer channels
        # (thread-safe by construction); the source iterator itself is
        # advanced exclusively on the pump thread.
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._should_stop = should_stop
        self._thread = threading.Thread(
            target=self._pump, args=(iter(src),), daemon=True,
            name="ingest-prefetch")
        self._thread.start()

    def _pump(self, src: Iterator[Any]) -> None:
        try:
            for item in src:
                if not self._put(("item", item)):
                    return
                ingest_metrics.PREFETCH_OCCUPANCY.set(self._q.qsize())
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._put(("error", e))

    def _put(self, msg) -> bool:
        """Bounded put that aborts when the consumer closed us — an
        abandoned epoch must not leave a thread parked on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[Any]:
        try:
            while True:
                try:
                    kind, item = self._q.get_nowait()
                except queue.Empty:
                    # The step outran the pipeline: blocked-here time IS
                    # input starvation.  Once the session is stopped AND
                    # the pipe stays dry past a grace window, stop waiting
                    # — the pump is wedged on something a teardown already
                    # gave up on (a graceful grow drain keeps yielding, so
                    # it never trips this).
                    t0 = time.monotonic()
                    while True:
                        try:
                            kind, item = self._q.get(timeout=0.5)
                            break
                        except queue.Empty:
                            if (self._should_stop is not None
                                    and self._should_stop()
                                    and time.monotonic() - t0 > 5.0):
                                from ray_tpu_torch.data.ingest.executor import (
                                    IngestAborted,
                                )

                                raise IngestAborted(
                                    "session stopped while the prefetch "
                                    "queue was starved")
                    starved = time.monotonic() - t0
                    ingest_metrics.STARVED_SECONDS.inc(starved)
                    w1 = time.time()
                    _profiler_record("data_wait", w1 - starved, w1)
                ingest_metrics.PREFETCH_OCCUPANCY.set(self._q.qsize())
                if kind == "end":
                    return
                if kind == "error":
                    raise item
                yield item
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        # Drain so a pump blocked on a full queue observes the stop at its
        # next timeout tick and exits.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class _PinnedRing:
    """Pinned host buffers for one column's shape and dtype, reused in
    turn. A buffer is handed out again only once the copy that last read
    it has finished (its event), so a batch staged later can never
    overwrite bytes a copy still reads."""

    def __init__(self, size: int):
        self._size = size
        self._slots: list = []  # [buffer, event or None]
        self._next = 0

    def acquire(self, shape, dtype, make):
        if len(self._slots) < self._size:
            slot = [make(shape, dtype), None]
            self._slots.append(slot)
            return slot
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self._size
        if slot[1] is not None:
            slot[1].synchronize()
            slot[1] = None
        return slot


class DeviceBatchIterator:
    """Double-buffered host->device transfer over a batch iterator.

    Yields batch N only after batch N+1's copy has been *started*: numeric
    columns go through pinned host buffers and a ``non_blocking`` copy on a
    side stream of ``device``, and the caller's current stream waits on the
    copy's event before batch N is yielded (no host sync).  ``device=None``
    is the card of the calling task or actor (its lease's, else the current
    CUDA device); ``"cpu"`` gives host tensors, copied at once.
    Non-numeric columns pass through on host. ``sharding`` (a mesh layout)
    waits for the port's ``DeviceMesh``.
    """

    #: Pinned buffers per column shape: batch N in the consumer's hands,
    #: N+1 in flight, N+2 staging.
    RING = 3

    def __init__(self, batches: Iterable[Dict[str, Any]], *,
                 device: Any = None, sharding: Any = None):
        if sharding is not None:
            raise NotImplementedError(
                "DeviceBatchIterator(sharding=...) needs the port's "
                "DeviceMesh (ROADMAP.md, Queue 1 item 3); pass device=")
        import torch

        from ray_tpu_torch._private.device import (
            granted_cuda_device,
            resolve_device,
        )

        dev = resolve_device(device)
        if device is None:
            dev = granted_cuda_device()
        self._src = batches
        self._device = dev
        self._cuda = dev.type == "cuda"
        self._stream = torch.cuda.Stream(dev) if self._cuda else None
        self._rings: Dict[tuple, _PinnedRing] = {}

    def _pinned(self, shape, dtype):
        import torch

        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _copy(self, batch: Dict[str, Any]):
        """Start the copy of one batch: (columns, event or None)."""
        import numpy as np
        import torch

        out: Dict[str, Any] = {}
        nbytes = 0
        slots = []
        for key, col in batch.items():
            arr = col if hasattr(col, "dtype") else np.asarray(col)
            if not hasattr(arr, "dtype") or arr.dtype.kind not in "biufc":
                out[key] = col
                continue
            nbytes += int(arr.nbytes)
            if not self._cuda:
                out[key] = torch.from_numpy(np.array(arr))
                continue
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            ring = self._rings.setdefault((arr.shape, dtype),
                                          _PinnedRing(self.RING))
            slot = ring.acquire(arr.shape, dtype, self._pinned)
            slot[0].numpy()[...] = arr
            slots.append(slot)
            with torch.cuda.stream(self._stream):
                out[key] = slot[0].to(self._device, non_blocking=True)
        telemetry = sys.modules.get("ray_tpu_torch.util.device_telemetry")
        if telemetry is not None and nbytes:
            telemetry.record_transfer("h2d", nbytes, src="ingest_prefetch")
        if not self._cuda:
            return out, None
        event = torch.cuda.Event()
        event.record(self._stream)
        for slot in slots:
            slot[1] = event
        return out, event

    def _transfer(self, batch: Dict[str, Any]):
        w0 = time.time()
        try:
            with tracing.span("data.prefetch"):
                last: Optional[BaseException] = None
                for _attempt in range(2):
                    try:
                        fault_injection.check("data_ingest_prefetch")
                        return self._copy(batch)
                    except WorkerCrashedError as e:
                        last = e
                raise last  # type: ignore[misc]
        finally:
            _profiler_record("h2d", w0, time.time())

    def _ready(self, staged) -> Dict[str, Any]:
        """Hand a batch to the caller's stream: it waits for the copy, and
        the allocator keeps each tensor until that stream is done with
        it."""
        out, event = staged
        if event is None:
            return out
        import torch

        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(consumer)
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = iter(self._src)
        try:
            cur = self._transfer(next(it))
        except StopIteration:
            return
        for nxt in it:
            nxt_dev = self._transfer(nxt)  # start N+1 before yielding N
            yield self._ready(cur)
            cur = nxt_dev
        yield self._ready(cur)
