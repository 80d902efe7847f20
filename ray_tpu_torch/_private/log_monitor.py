"""Worker log capture and the driver-side log monitor (the counterpart of
``ray_tpu/_private/log_monitor.py``; ref:
python/ray/_private/log_monitor.py:103 LogMonitor — tails
/tmp/ray/session_*/logs worker files and republishes lines to the driver
with (pid=...) prefixes; workers redirect stdout/stderr at startup).

Here: process-tier workers dup2 their stdout/stderr onto per-pid files
under ``<session>/logs`` (fd-level, so native prints are captured too);
the driver runs one tailer thread that follows every ``worker-*.out/err``
file and re-emits new lines prefixed ``(worker pid=N)``.  Thread-tier
workers share the driver's stdio and need no capture.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional


def log_dir(export: bool = False) -> str:
    """Resolved worker-log dir: env override first (so spawned workers and
    the driver agree), else the live config's session dir; export=True
    publishes the driver's resolved path for children (see
    config.session_subdir)."""
    from ray_tpu_torch._private.config import session_subdir

    return session_subdir("logs", "RAY_TPU_TORCH_WORKER_LOG_DIR", export=export)


def redirect_worker_output() -> None:
    """Called in every process worker's main: stdout/stderr → per-pid files
    at the FD level (dup2), so python prints, warnings, and native writes
    all land in the session log dir (ref: worker stdout/stderr redirection
    in _private/worker.py)."""
    try:
        d = log_dir()
        pid = os.getpid()
        out = open(os.path.join(d, f"worker-{pid}.out"), "a", buffering=1)
        err = open(os.path.join(d, f"worker-{pid}.err"), "a", buffering=1)
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
        sys.stdout = out
        sys.stderr = err
    except Exception:
        pass  # logging must never stop a worker from starting


class LogMonitor:
    """Tails worker-*.out/err under the session log dir, re-emitting new
    lines to the driver's stdout with a (worker pid=N) prefix."""

    #: Seconds between tail passes.
    POLL_INTERVAL_S = 0.2

    def __init__(self, emit: Optional[callable] = None,
                 skip_existing: bool = False):
        self._emit = emit or (lambda line: print(line, flush=True))
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if skip_existing:
            # The session dir outlives a driver: tail only what is written
            # from now on, not the logs of earlier drivers' workers.
            d = log_dir()
            for name in os.listdir(d):
                path = os.path.join(d, name)
                try:
                    self._offsets[path] = os.path.getsize(path)
                except OSError:
                    pass

    def start(self) -> "LogMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="log-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def poll_once(self) -> int:
        """One tail pass (also the test entry point); returns lines emitted."""
        d = log_dir()
        emitted = 0
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return 0
        for name in names:
            if not (name.startswith("worker-")
                    and name.endswith((".out", ".err"))):
                continue
            path = os.path.join(d, name)
            pid = name.split("-", 1)[1].rsplit(".", 1)[0]
            stream = "stderr" if name.endswith(".err") else "stdout"
            try:
                size = os.path.getsize(path)
                offset = self._offsets.get(path, 0)
                if size <= offset:
                    if size < offset:  # truncated/rotated: start over
                        self._offsets[path] = 0
                    continue
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
                # Hold back a trailing PARTIAL line (mid-write poll): emit
                # only through the last newline; the rest re-reads next pass.
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    continue
                self._offsets[path] = offset + cut + 1
                chunk = chunk[:cut]
            except OSError:
                continue
            for line in chunk.decode(errors="replace").splitlines():
                if line.strip():
                    prefix = f"(worker pid={pid})" if stream == "stdout" \
                        else f"(worker pid={pid}, stderr)"
                    self._emit(f"{prefix} {line}")
                    emitted += 1
        return emitted

    def _loop(self) -> None:
        while not self._stop.wait(self.POLL_INTERVAL_S):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the tailer must survive
                pass
