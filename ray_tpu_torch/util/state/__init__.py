"""State API: list/get/summarize cluster entities (the counterpart of
``ray_tpu/util/state/__init__.py``).

Counterpart of the reference's `ray.util.state` (ref: python/ray/util/state/
api.py + dashboard/modules/state/state_head.py:47): `ray list
tasks/actors/objects/nodes/placement-groups` and `ray summary`, fed by the
task-event store the runtime keeps (the role of the C++ `GcsTaskManager`,
gcs_task_manager.h:86).  Single-runtime model: reads go straight to the
runtime's in-process tables instead of over gRPC to the GCS.  The port's
runtime is one node, without labels: ``list_nodes`` gives its one row.
"""

from __future__ import annotations

from collections import Counter as _Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

Filter = Tuple[str, str, Any]  # (key, "="|"!=", value)


def _runtime():
    from ray_tpu_torch._private import runtime as _rt

    rt = _rt.runtime_or_none()
    if rt is None:
        raise RuntimeError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init()")
    return rt


def _apply_filters(rows: List[dict], filters: Optional[Sequence[Filter]],
                   limit: int) -> List[dict]:
    if filters:
        for key, op, value in filters:
            if op not in ("=", "!="):
                raise ValueError(f"unsupported filter op {op!r} (use = or !=)")
            rows = [r for r in rows
                    if (str(r.get(key)) == str(value)) == (op == "=")]
    return rows[:limit]


# ------------------------------------------------------------------- tasks
def _task_table() -> List[dict]:
    """Fold the event log into one row per task attempt (latest state wins)."""
    rt = _runtime()
    events = rt.list_task_events()
    rows: Dict[str, dict] = {}
    for ev in events:
        if ev.get("state", "").startswith("PROFILE"):
            continue
        tid = ev["task_id"]
        row = rows.setdefault(tid, {
            "task_id": tid, "name": ev.get("name", ""), "state": "",
            "start_time": None, "end_time": None, "error_type": "",
            "node_id": "", "actor_id": "",
        })
        row["state"] = ev["state"]
        for k in ("node_id", "actor_id"):
            if ev.get(k):
                row[k] = str(ev[k])
        if ev.get("error"):
            row["error_type"] = str(ev["error"])
        if ev["state"] == "RUNNING":
            row["start_time"] = ev["time"]
        if ev["state"] in ("FINISHED", "FAILED"):
            row["end_time"] = ev["time"]
    return list(rows.values())


def list_tasks(filters: Optional[Sequence[Filter]] = None,
               limit: int = 10_000) -> List[dict]:
    return _apply_filters(_task_table(), filters, limit)


def get_task(task_id: str) -> Optional[dict]:
    for row in _task_table():
        if row["task_id"] == str(task_id):
            return row
    return None


def summarize_tasks() -> dict:
    """Counts by (name, state) — `ray summary tasks`."""
    by_func: Dict[str, _Counter] = {}
    total = 0
    for row in _task_table():
        by_func.setdefault(row["name"], _Counter())[row["state"]] += 1
        total += 1
    return {"total": total,
            "by_func": {k: dict(v) for k, v in sorted(by_func.items())}}


# ------------------------------------------------------------------- actors
def list_actors(filters: Optional[Sequence[Filter]] = None,
                limit: int = 10_000) -> List[dict]:
    return _apply_filters(_runtime().list_actor_states(), filters, limit)


def get_actor(actor_id: str) -> Optional[dict]:
    for row in _runtime().list_actor_states():
        if row["actor_id"] == str(actor_id):
            return row
    return None


def summarize_actors() -> dict:
    by_class: Dict[str, _Counter] = {}
    rows = _runtime().list_actor_states()
    for row in rows:
        by_class.setdefault(row["class_name"], _Counter())[row["state"]] += 1
    return {"total": len(rows),
            "by_class": {k: dict(v) for k, v in sorted(by_class.items())}}


# ------------------------------------------------------------------ objects
def list_objects(filters: Optional[Sequence[Filter]] = None,
                 limit: int = 10_000) -> List[dict]:
    return _apply_filters(_runtime().store.object_summaries(), filters, limit)


def summarize_objects() -> dict:
    rows = _runtime().store.object_summaries()
    by_state: _Counter = _Counter()
    total_bytes = 0
    for row in rows:
        by_state[row["state"]] += 1
        total_bytes += row["size"]
    return {"total": len(rows), "total_bytes": total_bytes,
            "by_state": dict(by_state)}


# -------------------------------------------------------------------- nodes
def list_nodes(filters: Optional[Sequence[Filter]] = None,
               limit: int = 10_000) -> List[dict]:
    rows = []
    for snap in _runtime().nodes():
        rows.append({
            "node_id": str(snap["NodeID"]), "alive": snap["Alive"],
            "resources": snap["Resources"], "available": snap["Available"],
            "labels": dict(snap.get("Labels", {})),
        })
    return _apply_filters(rows, filters, limit)


# -------------------------------------------------------------------- serve
def _serve_controller():
    """The detached serve controller, or None when serve never started."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.api import _CONTROLLER_NAME

    try:
        return ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except ValueError:
        return None


def list_deployments(filters: Optional[Sequence[Filter]] = None,
                     limit: int = 10_000) -> List[dict]:
    """Deployment rows (controller state + RED rollups) — the serve
    counterpart of list_actors (ref: `ray list deployments` via the serve
    state API).  Empty when serve is not running."""
    import ray_tpu_torch

    controller = _serve_controller()
    if controller is None:
        return []
    rows = ray_tpu_torch.get(controller.list_deployments.remote(),
                             timeout=30.0)
    return _apply_filters(rows, filters, limit)


def list_replicas(filters: Optional[Sequence[Filter]] = None,
                  limit: int = 10_000) -> List[dict]:
    """Per-replica FSM rows (state, version, uptime, health bookkeeping).
    Empty when serve is not running."""
    import ray_tpu_torch

    controller = _serve_controller()
    if controller is None:
        return []
    rows = ray_tpu_torch.get(controller.list_replicas.remote(), timeout=30.0)
    return _apply_filters(rows, filters, limit)


# --------------------------------------------------------- train runs
def list_train_runs(filters: Optional[Sequence[Filter]] = None,
                    limit: int = 10_000) -> List[dict]:
    """Train-run rows from the controller's run registry: name, status,
    live world size vs target, last committed checkpoint step, elastic
    shrink/grow events (docs/observability.md).  The training counterpart
    of list_deployments.  Probed via sys.modules — importing the train
    package here would drag the trainer (and collective) into every state
    query; if it was never imported, no run can exist.  Works without a
    runtime: rows live in this process, not in runtime tables."""
    import sys

    registry = sys.modules.get("ray_tpu_torch.train.run_registry")
    if registry is None:
        return []
    return _apply_filters(registry.list_runs(), filters, limit)


def get_train_run(name: str) -> Optional[dict]:
    import sys

    registry = sys.modules.get("ray_tpu_torch.train.run_registry")
    if registry is None:
        return None
    return registry.get_run(str(name))


# --------------------------------------------------------- postmortems
def list_postmortems(filters: Optional[Sequence[Filter]] = None,
                     limit: int = 10_000) -> List[dict]:
    """Flight-recorder postmortem dumps in this session (one row per dump:
    id, pid, trigger reason, timestamp, ring/stall counts) — the index
    ``/api/postmortems`` serves.  Works
    without a runtime: rows are files under ``<session>/postmortems``."""
    from ray_tpu_torch.util import forensics

    return _apply_filters(forensics.list_postmortems(), filters, limit)


def get_postmortem(pm_id: str) -> Optional[dict]:
    """Full dump payload (ring, stacks, heap when traced) for one id."""
    from ray_tpu_torch.util import forensics

    return forensics.load_postmortem(str(pm_id))


# --------------------------------------------------------- placement groups
def list_placement_groups(filters: Optional[Sequence[Filter]] = None,
                          limit: int = 10_000) -> List[dict]:
    rt = _runtime()
    rows = []
    for pg in rt.scheduler.placement_groups():
        rows.append({
            "placement_group_id": str(pg.id), "name": pg.name,
            "state": pg.state, "strategy": pg.strategy,
            "bundles": [dict(b.resources) for b in pg.bundles],
        })
    return _apply_filters(rows, filters, limit)


__all__ = [
    "list_tasks", "get_task", "summarize_tasks",
    "list_actors", "get_actor", "summarize_actors",
    "list_objects", "summarize_objects",
    "list_nodes", "list_placement_groups",
    "list_deployments", "list_replicas",
    "list_train_runs", "get_train_run",
    "list_postmortems", "get_postmortem",
]
