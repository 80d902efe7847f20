"""Per-worker shard writer: async device->host snapshot + background persist
(the counterpart of ``ray_tpu/checkpoint/writer.py``).

Check-N-Run's decomposition (NSDI '22): the only work on the training
step's critical path is the device->host snapshot (a copy); serializing,
writing to storage, registering the in-memory replica and the two-phase
commit all happen on a dedicated background thread.  ``save_async``
returns a SaveHandle the moment the snapshot lands on host, and a serial
executor preserves step order per shard.

The snapshot is the device part (the reference's ``jax.device_get``).
Each CUDA leaf is copied into page-locked host memory by ``non_blocking``
copies on a side stream, which first waits on the caller's stream (the
step that wrote the leaf); the caller then waits for an event recorded
after the copies. So the copy reads what the step wrote, and the next
in-place update (the port's optimizer updates parameters and moments in
place) cannot start before it ends. A writer's page-locked buffers are a
pool of ``PINNED_BUFFERS`` sets (``PinnedPool``), reused: a set goes back
to the pool when the persist of its snapshot is done, a save that finds
none free waits for one (that wait is part of its block time), and a
replica payload holds its own copy of the bytes, never a pooled buffer.
A failed page-locked allocation raises; no pageable copy stands in for
it. Host leaves are copied as well (a tensor updated in place after the
save must not change it), and a tree with no CUDA leaf takes a slot of the
pool without a buffer: on the host too, at most ``PINNED_BUFFERS`` saves
of a writer are in flight, so a step can be reported at most that many
saves ahead of its last commit (the elastic Trainer's lost steps stay
within ``replica_memory_steps`` however slow the persists are).

The writer talks to a CheckpointCoordinator that may be a plain local
object (single-process) or an actor handle (multi-worker) — ``_invoke``
papers over the difference.

Chaos: the persist path consults the ``ckpt_shard_write`` fault point; an
injected (or real) failure aborts the pending step at the coordinator so
the commit can never include a half-written shard.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.checkpoint import layout
from ray_tpu_torch.checkpoint import metrics as ckpt_metrics
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

#: Byte alignment of each leaf inside a pinned snapshot buffer.
_ALIGN = 64
#: Pinned snapshot buffers per writer: the snapshot being taken and one
#: persisting; a third save waits for the older persist to finish.
PINNED_BUFFERS = 2
#: A host tree's lease: a slot of the pool that holds no buffer.
_HOST_SLOT = object()


def _profiler_record(bucket: str, start: float, end: float) -> None:
    """Attribute an interval to the train step profiler when one is active
    on this thread.  Probed via sys.modules — the checkpoint layer must not
    import the train package (trainer -> collective import chain), and if
    the profiler module was never imported, none can be active."""
    mod = sys.modules.get("ray_tpu_torch.train.profiler")
    if mod is not None:
        mod.record(bucket, start, end)


def _telemetry():
    """Device-telemetry plane iff loaded (same probe idiom): the snapshot
    is a device->host transfer and the host copy stages bytes in the
    ``ckpt_staging`` pool until its persist releases them."""
    return sys.modules.get("ray_tpu_torch.util.device_telemetry")


def _invoke(coordinator, method: str, *args):
    """Call a coordinator method whether it is local or an actor handle."""
    m = getattr(coordinator, method)
    remote = getattr(m, "remote", None)
    if remote is None:
        return m(*args)
    import ray_tpu_torch

    return ray_tpu_torch.get(remote(*args))


class PinnedPool:
    """Page-locked host buffers for snapshots: at most ``PINNED_BUFFERS``
    exist at once. ``acquire`` hands out a free one large enough, else
    allocates every empty slot at once (page-locking is slow: the first
    snapshot pays for the pool, later ones find a buffer ready), else
    waits for a ``release``; ``wait_seconds`` sums those waits.
    ``acquire(0)`` takes a slot without a buffer (a tree on the host). Also
    keeps one side stream per device for the copies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._free: List[Any] = []  # guarded_by: _lock
        self._leased = 0  # guarded_by: _lock
        #: seconds ``acquire`` has waited for a buffer to come back
        self.wait_seconds = 0.0
        self._streams: Dict[Any, Any] = {}

    def acquire(self, nbytes: int):
        with self._lock:
            while True:
                if not nbytes:
                    if self._leased < PINNED_BUFFERS:
                        self._leased += 1
                        return _HOST_SLOT
                else:
                    fits = [i for i, b in enumerate(self._free)
                            if b.numel() >= nbytes]
                    if fits:
                        best = min(fits, key=lambda i: self._free[i].numel())
                        self._leased += 1
                        return self._free.pop(best)
                    # Free buffers too small for this tree go, for larger
                    # ones.
                    self._free.clear()
                    room = PINNED_BUFFERS - self._leased
                    if room:
                        # Under the lock: a release waits for this, the once.
                        self._free.extend(self._allocate(nbytes)
                                          for _ in range(room))
                        continue
                t0 = time.monotonic()
                self._cond.wait()
                self.wait_seconds += time.monotonic() - t0

    @staticmethod
    def _allocate(nbytes: int):
        import torch

        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def release(self, buf) -> None:
        with self._lock:
            self._leased -= 1
            if buf is not _HOST_SLOT:
                self._free.append(buf)
            self._cond.notify()

    def stream(self, device):
        import torch

        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s


def snapshot_to_host(tree: Any, pool: PinnedPool) -> Tuple[Any, Any]:
    """-> (host tree, its lease to give back to ``pool``): the only
    step-blocking work.

    CUDA leaves land in one page-locked buffer from ``pool`` through a side
    stream per device; the call returns once the copies have landed. Host
    tensors and numpy arrays are copied; other leaves are kept as they
    are."""
    import torch
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(tree)
    out = list(leaves)
    on_card: Dict[Any, List[int]] = {}
    offsets: Dict[int, int] = {}
    nbytes = 0
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            on_card.setdefault(leaf.device, []).append(i)
            offsets[i] = nbytes
            size = leaf.numel() * leaf.element_size()
            nbytes += (size + _ALIGN - 1) // _ALIGN * _ALIGN
        elif isinstance(leaf, torch.Tensor):
            out[i] = leaf.detach().clone()
        elif isinstance(leaf, np.ndarray):
            out[i] = leaf.copy()
    if not on_card:
        return _pytree.tree_unflatten(out, spec), pool.acquire(0)
    buf = pool.acquire(nbytes)
    try:
        events = []
        for device, idx in on_card.items():
            side = pool.stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for i in idx:
                    src = leaves[i].detach()
                    size = src.numel() * src.element_size()
                    dst = buf[offsets[i]:offsets[i] + size].view(
                        src.dtype).view(src.shape)
                    out[i] = dst.copy_(src, non_blocking=True)
            events.append(side.record_event())
        for ev in events:
            ev.synchronize()
    except BaseException:
        pool.release(buf)
        raise
    return _pytree.tree_unflatten(out, spec), buf


class SaveHandle:
    """Future-ish handle for one async save."""

    def __init__(self, step: int, block_seconds: float,
                 wait_seconds: float):
        self._future: Optional[Future] = None
        self.step = step
        #: seconds the caller was blocked (a free buffer, the snapshot)
        self.block_seconds = block_seconds
        #: the part of ``block_seconds`` spent waiting for a free buffer
        self.wait_seconds = wait_seconds
        #: (start, end) ``time.time()`` of the persist, once it has run
        self.persist_window: Optional[Tuple[float, float]] = None

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> dict:
        """Waits for the persist; raises if the shard write failed."""
        return self._future.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout)


class ShardWriter:
    def __init__(self, coordinator, shard_id: int = 0, world_size: int = 1,
                 epoch: int = 0, replicate: bool = True,
                 pool: Optional[PinnedPool] = None):
        self.coordinator = coordinator
        self.shard_id = int(shard_id)
        self.world_size = int(world_size)
        self.epoch = int(epoch)
        self.replicate = replicate
        self._aborted = threading.Event()
        #: the snapshot buffers; a Trainer passes one per rank that outlives
        #: its attempts, so that a restart does not page-lock them again.
        self._pool = pool if pool is not None else PinnedPool()
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"ckpt-shard-{shard_id}")

    # ----------------------------------------------------------- save API
    def save_async(self, step: int, tree: Any) -> SaveHandle:
        """Snapshot now, persist in the background; blocks only for the
        device->host copy (and a free pinned buffer)."""
        t0 = time.monotonic()
        w0 = time.time()
        waited = self._pool.wait_seconds
        with tracing.span("checkpoint.save",
                          attributes={"step": step, "shard": self.shard_id,
                                      "phase": "snapshot"}):
            host_tree, lease = snapshot_to_host(tree, self._pool)
        block = time.monotonic() - t0
        self._ledger_snapshot(host_tree, w0, w0 + block)
        ckpt_metrics.SAVE_BLOCK_SECONDS.observe(block, tags={"mode": "async"})
        # The snapshot is the only save work blocking the training step —
        # attribute exactly it to the step profiler's ckpt_block bucket.
        _profiler_record("ckpt_block", w0, w0 + block)
        handle = SaveHandle(step, block, self._pool.wait_seconds - waited)
        try:
            handle._future = self._exec.submit(self._persist, step,
                                               host_tree, lease, handle)
        except BaseException:
            self._pool.release(lease)
            raise
        return handle

    def save_sync(self, step: int, tree: Any) -> dict:
        """Snapshot + persist inline (the baseline async saves beat)."""
        t0 = time.monotonic()
        with tracing.span("checkpoint.save",
                          attributes={"step": step, "shard": self.shard_id,
                                      "phase": "sync"}):
            w0 = time.time()
            host_tree, lease = snapshot_to_host(tree, self._pool)
            self._ledger_snapshot(host_tree, w0, time.time())
            manifest = self._persist(step, host_tree, lease)
        ckpt_metrics.SAVE_BLOCK_SECONDS.observe(time.monotonic() - t0,
                                                tags={"mode": "sync"})
        return manifest

    @staticmethod
    def _ledger_snapshot(host_tree: Any, start: float, end: float) -> None:
        """Ledger one device->host snapshot and stage its bytes in the
        ``ckpt_staging`` pool (released when the persist drops the host
        copy)."""
        dt = _telemetry()
        if dt is None:
            return
        nbytes = dt.tree_nbytes(host_tree)
        dt.record_transfer("d2h", nbytes, src="ckpt_snapshot",
                           start=start, end=end)
        dt.pool_add("ckpt_staging", nbytes)

    # ------------------------------------------------------------ persist
    def _persist(self, step: int, host_tree: Any, lease,
                 handle: Optional[SaveHandle] = None) -> dict:
        start = time.time()
        try:
            return self._persist_inner(step, host_tree)
        finally:
            # The snapshot's pinned buffer is free again once its bytes are
            # on storage (and copied into the replica payload); the host
            # staging copy's pool bytes are released whether the persist
            # committed, failed, or the writer was aborted before it ran.
            self._pool.release(lease)
            dt = _telemetry()
            if dt is not None:
                dt.pool_sub("ckpt_staging", dt.tree_nbytes(host_tree))
            if handle is not None:
                handle.persist_window = (start, time.time())

    def _persist_inner(self, step: int, host_tree: Any) -> dict:
        if self._aborted.is_set():
            raise RuntimeError("shard writer aborted")
        t0 = time.monotonic()
        try:
            with tracing.span("checkpoint.save",
                              attributes={"step": step, "shard": self.shard_id,
                                          "phase": "persist"}):
                fault_injection.check("ckpt_shard_write")
                doc, skeleton, kind, arrays = layout.build_shard(
                    host_tree, self.shard_id, self.world_size)
                tmp = _invoke(self.coordinator, "begin_save", step,
                              self.world_size, self.epoch)
                manifest = layout.write_shard(tmp, self.shard_id, doc,
                                              skeleton, kind, arrays, step)
                ckpt_metrics.BYTES_WRITTEN.inc(manifest["bytes"])
                self._put_replica(step, doc, skeleton, kind, arrays)
                _invoke(self.coordinator, "shard_complete", step,
                        self.shard_id, manifest, self.epoch)
        except BaseException as e:
            try:
                _invoke(self.coordinator, "shard_failed", step, self.shard_id,
                        repr(e), self.epoch)
            except Exception:
                pass
            logger.warning("checkpoint shard %s step %s failed: %r",
                           self.shard_id, step, e)
            raise
        ckpt_metrics.SAVE_SECONDS.observe(time.monotonic() - t0)
        return manifest

    def _put_replica(self, step: int, doc, skeleton, kind, arrays) -> None:
        if not self.replicate:
            return
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            return
        try:
            # The object store holds values by reference: the payload gets
            # its own bytes, since the snapshot's buffer is reused.
            payload = {"doc": doc, "skeleton": skeleton, "kind": kind,
                       "arrays": {k: np.array(a) for k, a in arrays.items()},
                       "shard_id": self.shard_id, "step": step}
            ref = ray_tpu_torch.put(payload)
            _invoke(self.coordinator, "put_replica", step, self.shard_id,
                    {"ref": ref})
        except Exception as e:  # replica tier is best-effort
            logger.debug("replica put failed for step %s shard %s: %r",
                         step, self.shard_id, e)

    # ---------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Wait until every queued persist has finished (commit included).
        Failures of individual saves do not raise here — the next commit
        supersedes them; inspect SaveHandles for per-save outcomes."""
        self._exec.submit(lambda: None).result(timeout)

    def abort(self) -> None:
        """Tear down: queued-but-unstarted persists become no-ops.  The
        persist already in flight (if any) may still complete — committing
        a fully written step is never wrong."""
        self._aborted.set()

    def close(self) -> None:
        self.abort()
        self._exec.shutdown(wait=False)
