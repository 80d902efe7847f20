"""Process-local registry of train runs (the counterpart of
``ray_tpu/train/run_registry.py``).

The training counterpart of the serve controller's deployment table: the
controller (``DataParallelTrainer.fit``) registers its run at start and
keeps the row current — world size, attempts, final status — so the
metrics agent's ``/api/train_runs`` route and the state API's
``list_train_runs`` (``util/state``) return a consistent snapshot of live
and finished runs without touching the trainer's internals.

Rows live in the controller's process (thread-tier training runs there);
the registry is bounded so a long-lived driver launching many fits never
grows without limit.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

#: Finished/failed runs retained after eviction kicks in (live runs are
#: never evicted).
_MAX_FINISHED = 64
#: Elastic events kept per run row (newest last).
_MAX_EVENTS = 32

_lock = threading.Lock()
_runs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()


def register_run(name: str, *, world_size: int, target_world: int,
                 path: str = "", elastic: bool = False) -> None:
    """Create (or reset — rerunning a name reuses it) a run row."""
    with _lock:
        _runs[name] = {
            "name": name,
            "status": "running",
            "world_size": world_size,
            "target_world": target_world,
            "elastic": elastic,
            "path": path,
            "started_at": time.time(),
            "finished_at": None,
            "last_committed_step": None,
            "last_reported_step": None,
            "attempts": 1,
            "events": [],
        }
        _runs.move_to_end(name)
        _evict_locked()


def update_run(name: str, **fields: Any) -> None:
    """Merge fields into a run row; unknown names are ignored (a row may
    have been evicted under a long-lived driver)."""
    with _lock:
        row = _runs.get(name)
        if row is None:
            return
        for k, v in fields.items():
            row[k] = v


def record_event(name: str, event: Dict[str, Any]) -> None:
    """Append an elastic shrink/grow/recover record to the run row."""
    with _lock:
        row = _runs.get(name)
        if row is None:
            return
        row["events"].append(dict(event))
        del row["events"][:-_MAX_EVENTS]


def finish_run(name: str, status: str) -> None:
    with _lock:
        row = _runs.get(name)
        if row is None:
            return
        row["status"] = status
        row["finished_at"] = time.time()
        _evict_locked()


def get_run(name: str) -> Optional[Dict[str, Any]]:
    with _lock:
        row = _runs.get(name)
        return _copy(row) if row is not None else None


def list_runs() -> List[Dict[str, Any]]:
    """Consistent snapshot of every known run (copies — callers can't
    mutate live rows)."""
    with _lock:
        return [_copy(row) for row in _runs.values()]


def clear() -> None:
    """Drop every row (tests)."""
    with _lock:
        _runs.clear()


def _copy(row: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(row)
    out["events"] = [dict(e) for e in row["events"]]
    return out


def _evict_locked() -> None:
    done = [n for n, r in _runs.items() if r["status"] != "running"]
    for name in done[:-_MAX_FINISHED] if len(done) > _MAX_FINISHED else []:
        del _runs[name]
