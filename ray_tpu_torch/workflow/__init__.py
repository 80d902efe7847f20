"""Workflows: durable DAG execution with per-step checkpointing (the
counterpart of ``ray_tpu/workflow/``).

Counterpart of the reference's `ray.workflow` (ref: python/ray/workflow/ —
workflow_executor.py, workflow_state_from_dag.py, workflow_storage.py):
`workflow.run(dag, workflow_id=...)` executes a `bind()`-built DAG with
every step's result checkpointed to storage the moment it completes; if the
driver dies mid-flow, `workflow.resume(workflow_id)` replays from the saved
step results instead of recomputing them (exactly-once per successful step).
Step semantics: retries with `max_retries`, exceptions recorded as workflow
failure, steps addressed by a content-derived step id.

Storage layout (filesystem, pluggable root):
  <root>/<workflow_id>/workflow.json       — status + DAG metadata
  <root>/<workflow_id>/steps/<step_id>.pkl — pickled step results
A step's result reaches later steps as its checkpoint holds it, tensors on
the host (api.py states the rule).
"""

from ray_tpu_torch.workflow.api import (
    WorkflowStatus,
    cancel,
    delete,
    get_output,
    get_status,
    init_storage,
    list_all,
    resume,
    run,
    run_async,
)

__all__ = [
    "WorkflowStatus", "cancel", "delete", "get_output", "get_status",
    "init_storage", "list_all", "resume", "run", "run_async",
]
