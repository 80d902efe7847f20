"""On-demand stack dumps of this process (the counterpart of
``ray_tpu/_private/stack_profiler.py``; ref:
python/ray/dashboard/modules/reporter/profile_manager.py:78 — py-spy stack
dumps of any worker from the dashboard; `ray stack` CLI).

The driver and its thread-tier workers share one process, so
``sys._current_frames`` sees every thread without interrupting it.  The
reference's signal-driven dumps of process-tier workers (a SIGUSR1
faulthandler per worker) come with the process tier (ROADMAP.md, Queue 1
item 13.8).
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict, List


def current_process_stacks() -> Dict[str, List[str]]:
    """Thread-name → formatted stack for THIS process (driver + thread-tier
    workers; ref: `ray stack` output shape)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[name] = traceback.format_stack(frame)
    return out


def dump_worker_stacks(pids: List[int], timeout_s: float = 2.0) -> Dict[int, str]:
    """Stacks of process-tier workers: the port has no process tier yet."""
    raise NotImplementedError(
        "stack dumps of process workers come with the process tier "
        "(ROADMAP.md, Queue 1 item 13.8)")


def collect_all_stacks() -> Dict[str, object]:
    """Every thread of this process, under ``"driver"`` (the reference's
    shape; its ``"process_workers"`` entry comes with the process tier)."""
    return {"driver": current_process_stacks()}
