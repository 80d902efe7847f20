"""On-demand stack dumps of the driver and every process worker (the
counterpart of ``ray_tpu/_private/stack_profiler.py``; ref:
python/ray/dashboard/modules/reporter/profile_manager.py:78 — py-spy stack
dumps of any worker from the dashboard; `ray stack` CLI).

- the driver and its thread-tier workers share one process, so
  ``sys._current_frames`` sees every thread without interrupting it;
- each process-tier worker registers a SIGUSR1 faulthandler at startup,
  writing to a per-pid file under the session dir; the driver signals the
  pid and collects the file (a signal reaches a worker mid-task, the
  property py-spy provides from outside).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
import traceback
from typing import Dict, List


def dump_dir(export: bool = False) -> str:
    """Driver side resolves from the live config (export=True publishes to
    env for spawned children); workers prefer the exported env value."""
    from ray_tpu_torch._private.config import session_subdir

    return session_subdir("stack_dumps", "RAY_TPU_TORCH_STACK_DUMP_DIR",
                          export=export)


# ---------------------------------------------------------------- worker side
def install_worker_dump_handler() -> None:
    """Called in every process worker's main: SIGUSR1 → dump all thread
    stacks to <session>/stack_dumps/<pid>.txt (faulthandler is async-signal
    -safe, unlike a Python-level handler formatting frames)."""
    import faulthandler

    try:
        path = os.path.join(dump_dir(), f"{os.getpid()}.txt")
        f = open(path, "w")
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
        # Keep the handle alive for the process lifetime.
        globals().setdefault("_dump_files", []).append(f)
    except Exception:
        pass  # profiling is best-effort; workers must start regardless


# ---------------------------------------------------------------- driver side
def drop_stale_dump(pid: int, since: float) -> None:
    """Driver side, just after spawning ``pid`` at ``since``: remove a dump
    file of that pid written before the spawn (by an earlier process that
    had the same pid), so ``dump_worker_stacks`` does not take it for the
    new worker's handler and signal the worker before it registers."""
    path = os.path.join(dump_dir(), f"{pid}.txt")
    try:
        if os.path.getmtime(path) < since:
            os.unlink(path)
    except OSError:
        pass


def current_process_stacks() -> Dict[str, List[str]]:
    """Thread-name → formatted stack for THIS process (driver + thread-tier
    workers; ref: `ray stack` output shape)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[name] = traceback.format_stack(frame)
    return out


#: Sentinel prefix for pids whose dump never arrived before the deadline —
#: callers (postmortem bundles, /api/stacks) can tell a missing worker from
#: a collected dump without parsing prose.
MISSING_DUMP_PREFIX = "<no dump before deadline"


def dump_worker_stacks(pids: List[int], timeout_s: float = 2.0) -> Dict[int, str]:
    """Signal each worker pid; collect its faulthandler dump file.

    A worker is only signaled once its dump file exists — the file is
    created when the handler registers, so its absence means the worker is
    still booting and SIGUSR1 would hit the DEFAULT disposition and kill it.
    (The pool removes a stale same-pid file from an older session when it
    spawns the worker: ``drop_stale_dump``.)

    The driver-side wait is bounded by ``timeout_s`` TOTAL (not per pid):
    a dead or wedged worker — SIGUSR1 masked, stuck in native code, killed
    between the signal and the write — is reported in the result under
    :data:`MISSING_DUMP_PREFIX` instead of blocking the collector, so a
    postmortem dump of a dying cluster always returns.
    """
    d = dump_dir()
    results: Dict[int, str] = {}
    marks: Dict[int, int] = {}
    for pid in pids:
        path = os.path.join(d, f"{pid}.txt")
        if not os.path.exists(path):
            results[pid] = "<worker still starting; dump handler not ready>"
            continue
        try:
            marks[pid] = os.path.getsize(path)
            os.kill(pid, signal.SIGUSR1)
        except (ProcessLookupError, PermissionError, OSError) as e:
            results[pid] = f"<unreachable: {e}>"
    deadline = time.monotonic() + timeout_s
    pending = [p for p in pids if p not in results]
    last_size: Dict[int, int] = {}
    while pending and time.monotonic() < deadline:
        time.sleep(min(0.05, timeout_s))
        for pid in list(pending):
            path = os.path.join(d, f"{pid}.txt")
            try:
                size = os.path.getsize(path)
                # Collect only once the dump is QUIESCENT (grew past the
                # mark, then unchanged across a poll) — faulthandler writes
                # incrementally and a partial read would drop thread stacks.
                if size > marks.get(pid, 0) and last_size.get(pid) == size:
                    with open(path) as f:
                        f.seek(marks.get(pid, 0))
                        results[pid] = f.read()
                    pending.remove(pid)
                else:
                    last_size[pid] = size
            except OSError:
                pass  # file vanished/unreadable this poll; deadline bounds us
    for pid in pending:
        results[pid] = (f"{MISSING_DUMP_PREFIX} ({timeout_s:.1f}s): worker "
                        "dead, signal masked, or busy in native code>")
    return results


def collect_all_stacks() -> Dict[str, object]:
    """Full cluster view: driver threads + every live process worker."""
    out: Dict[str, object] = {"driver": current_process_stacks()}
    pids = worker_pids()
    if pids:
        out["process_workers"] = dump_worker_stacks(pids)
    return out


def worker_pids() -> List[int]:
    """All live process-tier worker pids known to the runtime."""
    from ray_tpu_torch._private.runtime import runtime_or_none

    rt = runtime_or_none()
    if rt is None or not hasattr(rt, "process_pool"):
        return []
    pids = set(rt.process_pool.idle_pids())
    with rt._leased_lock:
        for w in rt._leased_workers.values():
            if w.alive():
                pids.add(w.proc.pid)
    with rt._actors_lock:
        for state in rt._actors.values():
            w = state.proc_worker
            if w is not None and w.alive():
                pids.add(w.proc.pid)
    return sorted(pids)


def format_stacks(stacks: Dict[str, object]) -> str:
    lines: List[str] = []
    for name, stack in sorted(stacks.get("driver", {}).items()):
        lines.append(f"=== driver thread: {name} ===")
        lines.extend(s.rstrip("\n") for s in stack)
    for pid, text in sorted(stacks.get("process_workers", {}).items()):
        lines.append(f"=== process worker pid={pid} ===")
        lines.append(str(text).rstrip("\n"))
    return "\n".join(lines)
