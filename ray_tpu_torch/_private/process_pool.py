"""Process worker pool for GIL-isolated task execution (the counterpart of
``ray_tpu/_private/process_pool.py``; ref: src/ray/raylet/worker_pool.h:216,
normal_task_submitter.h:74).

In the reference every task runs in a leased worker *process*; here, as in
``ray_tpu``, processes are the opt-in tier (``options(isolation="process")``
or a ``runtime_env``): thread-tier tasks and actors share the driver's
interpreter and its CUDA context.

Workers are started with ``spawn``, never ``fork``: the driver holds a CUDA
context, which a forked child cannot use. Each worker sees exactly the cards
its lease was granted: the first lines of ``_worker_main`` set
``CUDA_VISIBLE_DEVICES`` (empty for a lease without GPUs) before anything
in the child can initialise CUDA, and ``RAY_TPU_TORCH_WORKER_GPU_IDS`` to
the same cards as the driver numbers them, so ``get_gpu_ids()`` in the
worker returns the lease's ids and ``_private/device.py`` maps them to the
worker's local indices. Idle workers are kept for reuse keyed by
(runtime-env key, visible cards): a worker started without cards is never
leased for a GPU task.

Protocol per worker:
  driver -> worker: ("exec"|"exec_gen", seq, fn_id, fn_bytes|None, args_spec)
                    ("actor_call"|"actor_call_gen", seq, method, args_spec)
                    ("actor_new", seq, cls_bytes, actor_id, args_spec)
                    ("actor_exec", seq, fn_bytes, args_spec)
                    ("setup_env", payload), ("gen_stop", seq), ("shutdown",)
  worker -> driver: ("ok", seq, result_spec) | ("err", seq, flat_exc)
                    | ("yield", seq, item_spec)   [streaming kinds]
where a spec is ("inline", bytes) or ("plasma", key): a payload above
``plasma_handoff_threshold`` is written into the object store's shared-
memory arena (``ray_tpu_torch/native/plasma.py``), which every worker
attaches at start, and only its key rides the pipe; the side that takes it
deletes it. ``actor_exec`` runs a shipped function against the worker's
actor instance (the resident loops of compiled graphs and of the compiled
serve route's process lanes). ``HANDOFFS`` counts this process's payloads
by transport. A CUDA tensor crosses as a host copy (``serialization.py``):
its bytes count as a d2h transfer at the sender, under ``process_pool``.

The pipe is multiplexed by seq: the driver side has one reader thread per
worker routing replies to per-request queues, and the worker side runs
exec/actor_call requests on threads with a send lock, so a process actor
with max_concurrency > 1 really executes concurrently and streaming
generators interleave with other requests (ref: core_worker's concurrent
actor calls + streaming generator protocol, _raylet.pyx:1097). Functions
are cached worker-side by fn_id, so hot loops ship only args (ref: function
table export via GCS KV, _private/function_manager.py). A second pipe
carries the worker's own calls into the runtime (``client_runtime.py``).

Messages are read with ``recv_bytes`` below, not ``Connection.recv_bytes``:
the standard library asks the kernel for the whole rest of a message on
every read and allocates that much each time, while a pipe hands over at
most its buffer per read, so a message costs time quadratic in its size
where allocation is not free (on an NVIDIA H100 host, 400 MB from a
worker took 57 s through ``Connection.recv_bytes``).
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import struct
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG


def _read_into(fd: int, size: int, first: bool = False) -> bytearray:
    """Exactly ``size`` bytes of the pipe ``fd``, read into one buffer."""
    buf = bytearray(size)
    view = memoryview(buf)
    pos = 0
    while pos < size:
        n = os.readv(fd, [view[pos:]])
        if n == 0:
            if first and pos == 0:
                raise EOFError
            raise OSError("got end of file during message")
        pos += n
    return buf


def recv_bytes(conn) -> bytearray:
    """One message of a ``multiprocessing`` connection, framed as
    ``Connection.send_bytes`` frames it (a 4-byte big-endian size, or -1
    and an 8-byte size), in time linear in its size."""
    fd = conn.fileno()
    size, = struct.unpack("!i", _read_into(fd, 4, first=True))
    if size == -1:
        size, = struct.unpack("!Q", _read_into(fd, 8))
    return _read_into(fd, size)


#: The cards a worker was granted, as the driver numbers them (set in the
#: worker's environment; absent in the driver).
WORKER_GPU_IDS_ENV = "RAY_TPU_TORCH_WORKER_GPU_IDS"

#: ``time.time()`` when this process's worker loop started (None outside a
#: worker): a replica's cold start is measured from its spawn to here and on.
WORKER_MAIN_AT: Optional[float] = None

#: Idle process workers kept for reuse at most (ref: the worker pool's
#: cap); a released worker past it is stopped.
MAX_IDLE_WORKERS = 16

#: Masking the driver's ``__main__`` around a spawn is process-global: one
#: spawn at a time.
_SPAWN_LOCK = threading.Lock()


#: This process's payloads by transport: ``arena``/``pipe`` count them,
#: ``arena_bytes``/``pipe_bytes`` their bytes.
HANDOFFS = {"arena": 0, "pipe": 0, "arena_bytes": 0, "pipe_bytes": 0}

_HANDOFF_COUNTER = itertools.count(1)


def _next_handoff_key(prefix: str) -> str:
    return f"{prefix}:{os.getpid()}:{next(_HANDOFF_COUNTER)}"


def _attach_arena(path: Optional[str]):
    """The arena at ``path`` attached (None where there is no path)."""
    if not path:
        return None
    from ray_tpu_torch.native.plasma import PlasmaClient

    return PlasmaClient(path, create=False)


def _wire(value: Any) -> bytes:
    """``value``'s wire form, its CUDA tensors' host copies ledgered."""
    so = serialization.serialize(value)
    if so.d2h_bytes:
        dt = sys.modules.get("ray_tpu_torch.util.device_telemetry")
        if dt is not None:
            dt.record_transfer("d2h", so.d2h_bytes, src="process_pool")
    return so.to_bytes()


def _spec_put(arena, key: str, payload: bytes):
    """The transport of one payload: the arena above the threshold (the
    pipe where the arena is full or the key taken), else the pipe."""
    if arena is not None and \
            len(payload) > GLOBAL_CONFIG.plasma_handoff_threshold:
        try:
            arena.put_bytes(key, payload)
            HANDOFFS["arena"] += 1
            HANDOFFS["arena_bytes"] += len(payload)
            return ("plasma", key)
        except (MemoryError, ValueError):
            pass
    HANDOFFS["pipe"] += 1
    HANDOFFS["pipe_bytes"] += len(payload)
    return ("inline", payload)


def _spec_take(arena, spec):
    """The payload of one spec, a private writable copy for an arena
    handoff, whose object is deleted here."""
    kind, val = spec
    if kind == "inline":
        return val
    if kind != "plasma":
        raise RuntimeError(f"unknown payload transport {kind!r}")
    if arena is None:
        raise RuntimeError(
            f"peer sent arena handoff {val} but this side has no arena")
    view = arena.get(val, timeout=30)
    if view is None:
        raise RuntimeError(f"arena handoff object {val} missing")
    try:
        data = bytearray(view)
    finally:
        view.release()
        arena.release(val)
    arena.release(val)  # the creator's reference
    arena.delete(val)
    return data


def _spec_cleanup(arena, spec) -> None:
    """Free an unconsumed arena handoff (a no-op if the peer took it)."""
    if arena is None or spec is None or spec[0] != "plasma":
        return
    try:
        arena.release(spec[1])
        arena.delete(spec[1])
    except Exception:  # noqa: BLE001 — closed arena: nothing to free
        pass


def worker_gpu_ids() -> Tuple[int, ...]:
    """In a process worker, the cards it was granted as the driver numbers
    them; its own CUDA indices are their positions."""
    raw = os.environ.get(WORKER_GPU_IDS_ENV, "")
    return tuple(int(i) for i in raw.split(",") if i)


@contextmanager
def _task_context(actor_id):
    """Worker-side task context, so exit_actor(), get_runtime_context() and
    get_gpu_ids() work inside process-isolated tasks and actor methods."""
    from ray_tpu_torch._private.ids import TaskID
    from ray_tpu_torch._private.runtime import TaskContext, _task_ctx

    _task_ctx.ctx = TaskContext(TaskID.from_random(), actor_id,
                                gpu_ids=worker_gpu_ids())
    try:
        yield
    finally:
        _task_ctx.ctx = None


def _worker_main(conn, back_conn, visible_devices: str,
                 gpu_ids: Sequence[int], arena_path: Optional[str] = None
                 ) -> None:
    global WORKER_MAIN_AT
    WORKER_MAIN_AT = time.time()
    # The lease's cards, before anything in this process initialises CUDA
    # (ref: the worker's JAX_PLATFORMS=cpu, which keeps it off the chip).
    os.environ["CUDA_VISIBLE_DEVICES"] = visible_devices
    os.environ[WORKER_GPU_IDS_ENV] = ",".join(str(i) for i in gpu_ids)
    # On-demand stack dumps: SIGUSR1 -> faulthandler dump readable by the
    # driver (ref: py-spy via the reporter agent).
    from ray_tpu_torch._private.stack_profiler import (
        install_worker_dump_handler)

    install_worker_dump_handler()
    # Worker stdout/stderr -> per-pid session log files, tailed back to the
    # driver by the LogMonitor (ref: _private/log_monitor.py:103).
    from ray_tpu_torch._private.log_monitor import redirect_worker_output

    redirect_worker_output()
    fn_cache: Dict[str, Any] = {}
    actor_instance: List[Any] = [None, None]  # [instance, actor_id]
    arena = _attach_arena(arena_path)
    if arena is not None:
        # Channels unpickled here attach by path: they reuse this client.
        from ray_tpu_torch.dag.channel import seed_arena_client

        seed_arena_client(arena.path, arena)
    # Nested API: user code in this worker calls remote/get/put/wait
    # through the proxy runtime (client_runtime.py).
    from ray_tpu_torch._private.client_runtime import ClientRuntime
    from ray_tpu_torch._private.runtime import install_runtime

    install_runtime(ClientRuntime(
        back_conn, worker_id=f"proc-worker-{os.getpid()}"))

    send_lock = threading.Lock()
    #: Streams the driver abandoned (cancel/early error): the worker's
    #: yield loops check membership and stop pumping the user generator.
    stopped_streams: set = set()

    def send(msg) -> None:
        with send_lock:
            conn.send_bytes(serialization.dumps(msg))

    def reply_ok(seq, payload):
        send(("ok", seq, payload))

    def reply_err(seq, e):
        import traceback

        tb = traceback.format_exc()
        try:
            blob = serialization.dumps((e, tb))
        except Exception:
            blob = serialization.dumps((RuntimeError(repr(e)), tb))
        send(("err", seq, blob))

    def reply_value(seq, value):
        reply_ok(seq, _spec_put(arena, f"res:{os.getpid()}:{seq}",
                                _wire(value)))

    def stream(seq, items) -> None:
        for n, item in enumerate(items):
            if seq in stopped_streams:
                break  # the driver abandoned the stream
            send(("yield", seq, _spec_put(
                arena, f"res:{os.getpid()}:{seq}:{n}", _wire(item))))
        stopped_streams.discard(seq)
        reply_ok(seq, None)

    def take_args(args_spec):
        return serialization.deserialize_flat(
            memoryview(_spec_take(arena, args_spec)))

    def run_exec(seq, fn_id, fn_bytes, args_spec, streaming):
        try:
            if fn_id not in fn_cache:
                if fn_bytes is not None:
                    fn_cache[fn_id] = serialization.loads(fn_bytes)
                else:
                    # Concurrent first use: another in-flight request
                    # carries the bytes; wait for its thread to cache them.
                    deadline = time.monotonic() + 10
                    while fn_id not in fn_cache:
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"function {fn_id} never arrived")
                        time.sleep(0.005)
            fn = fn_cache[fn_id]
            args, kwargs = take_args(args_spec)
            with _task_context(None):
                if streaming:
                    stream(seq, fn(*args, **kwargs))
                    return
                result = fn(*args, **kwargs)
            reply_value(seq, result)
        except BaseException as e:  # noqa: BLE001 — errors cross the boundary
            reply_err(seq, e)

    def run_actor_call(seq, method_name, args_spec, streaming):
        try:
            if actor_instance[0] is None:
                raise RuntimeError("actor_call before actor_new")
            method = getattr(actor_instance[0], method_name)
            args, kwargs = take_args(args_spec)
            # _ActorExit crosses back via reply_err and is unwrapped on the
            # driver's side.
            with _task_context(actor_instance[1]):
                if streaming:
                    stream(seq, method(*args, **kwargs))
                    return
                result = method(*args, **kwargs)
            reply_value(seq, result)
        except BaseException as e:  # noqa: BLE001
            reply_err(seq, e)

    def run_actor_exec(seq, fn_bytes, args_spec):
        """A shipped function against the actor instance: a resident loop,
        long-running, beside the actor's ordinary calls."""
        try:
            if actor_instance[0] is None:
                raise RuntimeError("actor_exec before actor_new")
            fn = serialization.loads(fn_bytes)
            args, kwargs = take_args(args_spec)
            with _task_context(actor_instance[1]):
                result = fn(actor_instance[0], *args, **kwargs)
            reply_value(seq, result)
        except BaseException as e:  # noqa: BLE001
            reply_err(seq, e)

    #: Bound on concurrent in-worker requests (an actor's max_concurrency is
    #: enforced by the driver's mailbox threads; this is a backstop).
    work_sem = threading.BoundedSemaphore(64)

    def spawn(target, *args):
        def run():
            with work_sem:
                target(*args)

        threading.Thread(target=run, daemon=True).start()

    while True:
        try:
            msg = recv_bytes(conn)
        except (EOFError, OSError):
            break
        req = serialization.loads(msg)
        kind = req[0]
        if kind == "setup_env":
            # Applied once per worker; the pool keys leases by env, so a
            # worker only ever hosts one runtime env (ref: worker_pool.h
            # runtime-env-keyed caching).
            try:
                from ray_tpu_torch._private.runtime_env import apply_in_worker

                apply_in_worker(req[1])
                reply_ok(0, None)
            except BaseException as e:  # noqa: BLE001
                reply_err(0, e)
        elif kind in ("exec", "exec_gen"):
            _, seq, fn_id, fn_bytes, args_spec = req
            # Off-thread: concurrent requests must not serialize behind one
            # another.
            spawn(run_exec, seq, fn_id, fn_bytes, args_spec,
                  kind == "exec_gen")
        elif kind == "actor_new":
            # This worker becomes a dedicated actor host for its lifetime
            # (ref: the reference runs every actor in its own process).
            _, seq, cls_bytes, actor_id, args_spec = req
            try:
                cls = serialization.loads(cls_bytes)
                args, kwargs = take_args(args_spec)
                with _task_context(actor_id):
                    actor_instance[0] = cls(*args, **kwargs)
                actor_instance[1] = actor_id
                reply_ok(seq, None)
            except BaseException as e:  # noqa: BLE001
                reply_err(seq, e)
        elif kind in ("actor_call", "actor_call_gen"):
            _, seq, method_name, args_spec = req
            spawn(run_actor_call, seq, method_name, args_spec,
                  kind == "actor_call_gen")
        elif kind == "actor_exec":
            _, seq, fn_bytes, args_spec = req
            spawn(run_actor_exec, seq, fn_bytes, args_spec)
        elif kind == "gen_stop":
            stopped_streams.add(req[1])
        elif kind == "shutdown":
            break
    if arena is not None:
        # Every loop of this worker has returned or is dying with it: no
        # call on another thread can meet the freed handle (close waits).
        arena.close()


_LOG_MONITOR = None
_LOG_MONITOR_LOCK = threading.Lock()


def _ensure_log_monitor() -> None:
    """One driver-wide tailer streaming worker logs back to this terminal
    (ref: LogMonitor publishes to the driver via GCS pubsub; in-process
    here)."""
    global _LOG_MONITOR
    with _LOG_MONITOR_LOCK:
        if _LOG_MONITOR is None:
            from ray_tpu_torch._private.log_monitor import LogMonitor

            _LOG_MONITOR = LogMonitor(skip_existing=True).start()


def stop_log_monitor() -> None:
    """Runtime shutdown: end the tailer, after one last pass, so a later
    init (possibly with another session dir) doesn't inherit it."""
    global _LOG_MONITOR
    with _LOG_MONITOR_LOCK:
        if _LOG_MONITOR is not None:
            _LOG_MONITOR.stop()
            try:
                _LOG_MONITOR.poll_once()
            except Exception:  # noqa: BLE001 — the tailer is best-effort
                pass
            _LOG_MONITOR = None


def _visible_devices(gpu_ids: Sequence[int]) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a worker granted ``gpu_ids``: the
    driver's own visible list, if it has one, translates its indices."""
    parent = os.environ.get("CUDA_VISIBLE_DEVICES")
    if parent is None:
        return ",".join(str(i) for i in gpu_ids)
    names = [d.strip() for d in parent.split(",") if d.strip()]
    return ",".join(names[i] for i in gpu_ids)


def _spawn(proc) -> None:
    """Start ``proc`` without the driver's ``__main__``: spawn's prepare step
    would run it again in the child, from its file or, for ``python -m``,
    by its module name (a "<stdin>" pseudo-file would crash the child, and a
    driver without a main guard would start its own workers). The child
    needs none of it: everything of ``__main__`` travels by value
    (serialization.py). Mask both for the duration of ``start()``."""
    main = getattr(sys.modules.get("__main__"), "__dict__", {})
    with _SPAWN_LOCK:
        saved = {k: main[k] for k in ("__file__", "__spec__") if k in main}
        main.pop("__file__", None)
        if "__spec__" in saved:
            main["__spec__"] = None
        try:
            proc.start()
        finally:
            main.update(saved)


class _ProcWorker:
    def __init__(self, env_key: str = "", env_payload: Optional[dict] = None,
                 gpu_ids: Sequence[int] = (), arena_path: Optional[str] = None,
                 arena=None) -> None:
        self.gpu_ids = tuple(gpu_ids)
        #: The pool's driver-side arena client (None: every payload rides
        #: the pipe).
        self._arena = arena
        #: The idle pool's key: a worker is reused only for its env and cards.
        self.key = (env_key, self.gpu_ids)
        #: ``time.time()`` just before the spawn.
        self.spawned_at = time.time()

        # Export resolved dirs so the spawned child (which sees only config
        # defaults) writes its SIGUSR1 dump file and stdout/stderr logs
        # where this driver will look for them.
        from ray_tpu_torch._private.log_monitor import log_dir
        from ray_tpu_torch._private.stack_profiler import (
            drop_stale_dump, dump_dir)

        dump_dir(export=True)
        log_dir(export=True)
        _ensure_log_monitor()

        ctx = mp.get_context("spawn")
        self.conn, child_conn = ctx.Pipe()
        # Second pipe: the worker-initiated nested-API backchannel, serviced
        # by a dedicated driver thread (client_runtime.serve_backchannel) so
        # a child blocking in get() is independent of this request pipe.
        back_parent, back_child = ctx.Pipe()
        self.proc = ctx.Process(
            target=_worker_main, daemon=True,
            args=(child_conn, back_child, _visible_devices(self.gpu_ids),
                  self.gpu_ids, arena_path))
        _spawn(self.proc)
        drop_stale_dump(self.proc.pid, self.spawned_at)
        child_conn.close()
        back_child.close()
        from ray_tpu_torch._private.client_runtime import serve_backchannel

        self._back_thread = threading.Thread(
            target=serve_backchannel, args=(back_parent,),
            name=f"backchannel-{self.proc.pid}", daemon=True)
        self._back_thread.start()
        self._seq_counter = itertools.count(1)  # next() is atomic
        self.sent_fns: set = set()
        # Sends serialize under this lock; a reader thread routes replies
        # (ok/err/yield) to per-seq queues.
        self._send_lock = threading.Lock()
        self._pending: Dict[int, "queue.SimpleQueue"] = {}
        self._pending_lock = threading.Lock()
        self._dead = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"procworker-read-{self.proc.pid}",
            daemon=True)
        self._reader.start()
        if env_payload is not None:
            from ray_tpu_torch.exceptions import TaskError

            q = self._register(0)
            with self._send_lock:
                self.conn.send_bytes(
                    serialization.dumps(("setup_env", env_payload)))
            kind, payload = q.get()
            self._unregister(0)
            if kind == "err":
                exc, tb = serialization.loads(payload)
                self.kill()
                raise TaskError(exc, tb=tb)
            if kind == "crash":
                self.kill()
                raise RuntimeError("process worker died during env setup")

    # ----------------------------------------------------------- multiplexer
    def _register(self, seq: int):
        q = queue.SimpleQueue()
        with self._pending_lock:
            if self._dead:
                q.put(("crash", None))
            self._pending[seq] = q
        return q

    def _unregister(self, seq: int) -> None:
        with self._pending_lock:
            self._pending.pop(seq, None)

    def _read_loop(self) -> None:
        while True:
            try:
                reply = serialization.loads(recv_bytes(self.conn))
            except Exception:  # EOF, a closed pipe, a torn message
                break
            rkind, seq, payload = reply
            with self._pending_lock:
                q = self._pending.get(seq)
            if q is not None:
                q.put((rkind, payload))
            elif rkind == "yield":
                # A stream abandoned before this item came: its arena
                # object would otherwise stay forever.
                _spec_cleanup(self._arena, payload)
        # Worker gone: wake every in-flight request with a crash marker.
        with self._pending_lock:
            self._dead = True
            waiters = list(self._pending.values())
        for q in waiters:
            q.put(("crash", None))

    def _submit(self, kind: str, header_rest: tuple, args: tuple,
                kwargs: dict):
        """Ship one request; returns (seq, queue, args spec)."""
        seq = next(self._seq_counter)
        args_spec = _spec_put(self._arena, _next_handoff_key("args"),
                              _wire((args, kwargs)))
        q = self._register(seq)
        try:
            with self._send_lock:
                self.conn.send_bytes(serialization.dumps(
                    (kind, seq) + header_rest + (args_spec,)))
        except (EOFError, OSError) as e:
            from ray_tpu_torch.exceptions import WorkerCrashedError

            self._unregister(seq)
            _spec_cleanup(self._arena, args_spec)
            raise WorkerCrashedError(f"process worker died: {e}") from e
        return seq, q, args_spec

    @staticmethod
    def _raise_reply_error(payload):
        from ray_tpu_torch._private.runtime import _ActorExit
        from ray_tpu_torch.exceptions import TaskError

        exc, tb = serialization.loads(payload)
        if isinstance(exc, _ActorExit):
            # exit_actor() inside a process actor: re-raise unwrapped so the
            # runtime's actor FSM sees it.
            raise exc
        raise TaskError(exc, tb=tb)

    def _roundtrip(self, kind: str, header_rest: tuple, args: tuple,
                   kwargs: dict, raw: bool = False) -> Any:
        """One request/reply over the multiplexed pipe: the result, or its
        wire form with ``raw``. Raises WorkerCrashedError if the process
        dies, TaskError on a worker-side exception."""
        from ray_tpu_torch.exceptions import WorkerCrashedError

        arena = self._arena
        seq, q, args_spec = self._submit(kind, header_rest, args, kwargs)
        try:
            rkind, payload = q.get()
        finally:
            self._unregister(seq)
        if rkind == "crash":
            # Reclaim the args if unconsumed, and a result the worker wrote
            # before it died.
            _spec_cleanup(arena, args_spec)
            _spec_cleanup(arena, ("plasma", f"res:{self.proc.pid}:{seq}"))
            raise WorkerCrashedError("process worker died")
        if rkind == "ok":
            if payload is None:
                return None
            flat = _spec_take(arena, payload)
            if raw:
                return flat
            return serialization.deserialize_flat(memoryview(flat))
        _spec_cleanup(arena, args_spec)  # it may have failed before taking
        self._raise_reply_error(payload)

    def _stream(self, kind: str, header_rest: tuple, args: tuple,
                kwargs: dict):
        """Streaming request: yields items as the worker produces them;
        ends on the worker's ok (end) / err (raised) / crash."""
        from ray_tpu_torch.exceptions import WorkerCrashedError

        arena = self._arena
        seq, q, args_spec = self._submit(kind, header_rest, args, kwargs)
        finished = False
        try:
            while True:
                rkind, payload = q.get()
                if rkind == "yield":
                    yield serialization.deserialize_flat(
                        memoryview(_spec_take(arena, payload)))
                    continue
                finished = True
                if rkind == "ok":
                    return
                _spec_cleanup(arena, args_spec)
                if rkind == "crash":
                    raise WorkerCrashedError("process worker died mid-stream")
                self._raise_reply_error(payload)
        finally:
            self._unregister(seq)
            while not finished and not q.empty():
                rkind, payload = q.get()
                if rkind == "yield":
                    _spec_cleanup(arena, payload)
            if not finished:
                # The consumer abandoned the stream: tell the worker to
                # stop pumping it.
                try:
                    with self._send_lock:
                        self.conn.send_bytes(
                            serialization.dumps(("gen_stop", seq)))
                except (EOFError, OSError):
                    pass

    def _fn_bytes(self, fn_id: str, fn) -> Optional[bytes]:
        """The function's pickle on its first trip to this worker, else
        None (the worker has it cached)."""
        if fn_id in self.sent_fns:
            return None
        blob = serialization.dumps(fn)
        self.sent_fns.add(fn_id)
        return blob

    def execute(self, fn_id: str, fn, args: tuple, kwargs: dict,
                raw: bool = False) -> Any:
        """Run one task (its result's wire form with ``raw``); raises
        WorkerCrashedError if the process dies."""
        return self._roundtrip("exec", (fn_id, self._fn_bytes(fn_id, fn)),
                               args, kwargs, raw)

    def execute_gen(self, fn_id: str, fn, args: tuple, kwargs: dict):
        """Run one GENERATOR task; yields items as the worker sends them."""
        return self._stream("exec_gen", (fn_id, self._fn_bytes(fn_id, fn)),
                            args, kwargs)

    def actor_new(self, cls_bytes: bytes, actor_id: str, args: tuple,
                  kwargs: dict) -> None:
        """Instantiate an actor in this worker (dedicates the worker)."""
        self._roundtrip("actor_new", (cls_bytes, actor_id), args, kwargs)

    def actor_call(self, method_name: str, args: tuple, kwargs: dict,
                   raw: bool = False) -> Any:
        """Invoke a method on the worker-resident actor instance (its
        result's wire form with ``raw``)."""
        return self._roundtrip("actor_call", (method_name,), args, kwargs,
                               raw)

    def actor_exec(self, fn_bytes: bytes, args: tuple, kwargs: dict) -> Any:
        """Run ``fn(instance, *args, **kwargs)`` against the worker-resident
        actor instance (resident loops: compiled graphs, serve lanes)."""
        return self._roundtrip("actor_exec", (fn_bytes,), args, kwargs)

    def actor_call_gen(self, method_name: str, args: tuple, kwargs: dict):
        """Invoke a GENERATOR method; yields items as the worker sends them."""
        return self._stream("actor_call_gen", (method_name,), args, kwargs)

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        try:
            self.proc.terminate()
        except Exception:
            pass


class ProcessPool:
    """Idle pool of reusable spawned workers, keyed by (runtime-env key,
    visible cards)."""

    def __init__(self, arena_path: Optional[str] = None, arena=None) -> None:
        #: The object store's arena, which every worker attaches, and the
        #: store's client of it on this side (ref: runtime.py:303).
        self.arena_path = arena_path
        self._arena = arena if arena is not None else _attach_arena(arena_path)
        #: Idle workers by key (ref: the runtime-env-keyed WorkerPool cache,
        #: worker_pool.h:216; here the cards are part of the key).
        self._idle: Dict[tuple, List[_ProcWorker]] = {}
        self._lock = threading.Lock()
        self._count = 0
        #: Every worker this pool started, so shutdown reaps them all.
        self._started: List[_ProcWorker] = []
        self._closed = False

    def lease(self, env_key: str = "", env_payload: Optional[dict] = None,
              gpu_ids: Sequence[int] = ()) -> _ProcWorker:
        key = (env_key, tuple(gpu_ids))
        with self._lock:
            if self._closed:
                raise RuntimeError("the process pool is shut down")
            pool = self._idle.get(key, [])
            while pool:
                w = pool.pop()
                if w.alive():
                    return w
                self._count -= 1
            self._count += 1
        try:
            w = _ProcWorker(env_key=env_key, env_payload=env_payload,
                            gpu_ids=gpu_ids, arena_path=self.arena_path,
                            arena=self._arena)
        except BaseException:
            with self._lock:
                self._count -= 1
            raise
        with self._lock:
            closed = self._closed
            if not closed:
                self._started = [s for s in self._started if s.alive()]
                self._started.append(w)
        if closed:  # shut down while this worker started
            w.kill()
            w.proc.join(5.0)
            raise RuntimeError("the process pool is shut down")
        return w

    def release(self, worker: _ProcWorker) -> None:
        if not worker.alive():
            with self._lock:
                self._count -= 1
            return
        with self._lock:
            if self._count <= MAX_IDLE_WORKERS:
                self._idle.setdefault(worker.key, []).append(worker)
                return
            self._count -= 1
        worker.kill()

    def discard(self, worker: _ProcWorker) -> None:
        with self._lock:
            self._count -= 1
        worker.kill()

    def idle_pids(self) -> List[int]:
        with self._lock:
            return [w.proc.pid for pool in self._idle.values() for w in pool
                    if w.alive()]

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Stop every worker this pool started, idle or leased, and reap
        each: none outlives the runtime (a worker that kept its CUDA
        context would skew whatever runs on the card next)."""
        with self._lock:
            self._closed = True
            idle = [w for pool in self._idle.values() for w in pool]
            workers, self._started = self._started, []
            self._idle, self._count = {}, 0
        for w in idle:
            try:
                w.conn.send_bytes(serialization.dumps(("shutdown",)))
            except Exception:
                pass
        for w in workers:
            w.kill()
        deadline = time.monotonic() + timeout_s
        for w in workers:
            w.proc.join(max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(1.0)
