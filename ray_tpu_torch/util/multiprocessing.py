"""multiprocessing.Pool API over ray_tpu_torch tasks (the counterpart of
``ray_tpu/util/multiprocessing.py``; ref:
python/ray/util/multiprocessing/pool.py — drop-in Pool whose work items
run as cluster tasks instead of local forked processes)."""

from __future__ import annotations

import itertools
import threading
import uuid
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

# Per-executing-process once-guard for pool initializers.  Module-level so
# the remote chunk function below pickles by reference (a closure over a
# threading.Lock is unpicklable and would break process-tier pools).
_INIT_LOCK = threading.Lock()
_INITIALIZED_POOLS: set = set()


def _run_chunk_impl(pool_id, init, iargs, fn, chunk, star):
    if init is not None:
        with _INIT_LOCK:  # once-guard per pool per process, no races
            if pool_id not in _INITIALIZED_POOLS:
                init(*iargs)
                _INITIALIZED_POOLS.add(pool_id)
    if star:
        return [fn(*a) for a in chunk]
    return [fn(a) for a in chunk]


# Wrapped separately (not via decorator) so `_run_chunk_impl` stays reachable
# under its own module attribute: the port's pickler then sends it BY
# REFERENCE (_private/serialization.py); a decorator would shadow the name and
# force by-value pickling, dragging the module-global lock above into the
# payload (unpicklable).
_run_chunk = ray_tpu_torch.remote(_run_chunk_impl)


def _default_processes() -> int:
    """Cluster CPU count, else the host's (a runtime without a scheduler
    view of its own)."""
    try:
        return max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
    except Exception:
        import os

        return max(1, os.cpu_count() or 1)


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool,
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._refs = refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._fired = False

    def get(self, timeout: Optional[float] = None):
        from ray_tpu_torch.exceptions import GetTimeoutError

        try:
            vals = ray_tpu_torch.get(self._refs, timeout=timeout)
        except GetTimeoutError:
            raise  # a timeout is not a task failure: callbacks stay unfired
        except Exception as e:
            if self._error_callback is not None and not self._fired:
                self._fired = True
                self._error_callback(e)
            raise
        value = vals[0] if self._single else vals
        if self._callback is not None and not self._fired:
            self._fired = True
            self._callback(value)
        return value

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")  # multiprocessing contract
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Cluster-backed process pool.  ``processes`` bounds concurrent chunks
    (defaults to cluster CPUs); tasks inherit the usual scheduling."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        ray_tpu_torch.init(ignore_reinit_error=True)
        if processes is None:
            processes = _default_processes()
        self._processes = processes
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False
        self._pool_id = uuid.uuid4().hex

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def _submit_chunk(self, fn, chunk, star):
        return _run_chunk.remote(self._pool_id, self._initializer,
                                 self._initargs, fn, chunk, star)

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        """Lazy chunking — never materializes the full iterable (matters for
        imap over large/endless streams)."""
        if chunksize is None:
            # Without len() we cannot derive the multiprocessing heuristic;
            # a modest fixed chunk keeps tasks coarse enough.
            chunksize = 8
        it = iter(iterable)
        while True:
            chunk = list(itertools.islice(it, chunksize))
            if not chunk:
                return
            yield chunk

    # ------------------------------------------------------------- map APIs
    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize: Optional[int] = None,
                  callback: Optional[Callable] = None,
                  error_callback: Optional[Callable] = None,
                  _star: bool = False):
        self._check_open()
        refs = [self._submit_chunk(fn, c, _star)
                for c in self._chunks(iterable, chunksize)]
        return _ChunkedResult(refs, callback=callback,
                              error_callback=error_callback)

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        # Items star-unpack ONLY here; map passes each item as one argument
        # even when it is a tuple (the multiprocessing contract).
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn: Callable, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None,
                      callback: Optional[Callable] = None,
                      error_callback: Optional[Callable] = None):
        return self.map_async(fn, [tuple(a) for a in iterable], chunksize,
                              callback=callback, error_callback=error_callback,
                              _star=True)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        """Lazily yields in order with a window of chunks in flight — real
        pipelining, unlike submit-then-wait per chunk."""
        self._check_open()
        window = max(2, self._processes)
        pending: List[Any] = []
        chunks = self._chunks(iterable, chunksize)
        done = False
        while not done or pending:
            while not done and len(pending) < window:
                try:
                    chunk = next(chunks)
                except StopIteration:
                    done = True
                    break
                pending.append(self._submit_chunk(fn, chunk, False))
            if pending:
                for v in ray_tpu_torch.get(pending.pop(0)):
                    yield v

    imap_unordered = imap  # chunk-granular ordering is close enough here

    # ------------------------------------------------------------ apply APIs
    def apply(self, fn: Callable, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None,
                    callback: Optional[Callable] = None,
                    error_callback: Optional[Callable] = None):
        self._check_open()
        kwds = kwds or {}

        @ray_tpu_torch.remote
        def run_one():
            return fn(*args, **kwds)

        return AsyncResult([run_one.remote()], single=True,
                           callback=callback, error_callback=error_callback)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _ChunkedResult(AsyncResult):
    def __init__(self, refs: List[Any],
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        super().__init__(refs, single=False, callback=callback,
                         error_callback=error_callback)

    def get(self, timeout: Optional[float] = None):
        from ray_tpu_torch.exceptions import GetTimeoutError

        try:
            chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        except GetTimeoutError:
            raise  # a timeout is not a task failure: callbacks stay unfired
        except Exception as e:
            if self._error_callback is not None and not self._fired:
                self._fired = True
                self._error_callback(e)
            raise
        out: List[Any] = []
        for chunk in chunks:
            out.extend(chunk)
        if self._callback is not None and not self._fired:
            self._fired = True
            self._callback(out)
        return out
