"""Durable workflow execution (the counterpart of
``ray_tpu/workflow/api.py``; ref: python/ray/workflow/workflow_executor.py,
workflow_storage.py, workflow_state_from_dag.py).

``run(dag, workflow_id=...)`` executes a ``bind()``-built DAG with every
FunctionNode step checkpointed to storage the moment it completes.  Step ids
are content-derived (function identity + constant args + upstream step ids),
so ``resume(workflow_id)`` replays the saved results of finished steps and
recomputes only the rest — exactly-once per successful step, even across
driver crashes (the DAG and inputs are persisted at submission).

Storage layout (filesystem; root via init_storage() or
RAY_TPU_WORKFLOW_ROOT, default ``~/.ray_tpu_torch/workflows``):
  <root>/<workflow_id>/workflow.json       — status + metadata
  <root>/<workflow_id>/dag.pkl             — pickled DAG + inputs (for resume)
  <root>/<workflow_id>/steps/<step_id>.pkl — pickled step results
  <root>/<workflow_id>/output.pkl          — final result
  <root>/<workflow_id>/cancel              — cancellation marker

Device rule: a step's result reaches the steps downstream of it, and
``run``'s caller, as its checkpoint holds it, whether the step ran in this
run or was read back from ``steps/<step_id>.pkl`` on resume.  The port's
pickler sends a CUDA tensor as a host copy (``_private/serialization.py``),
so a tensor a step returns on the card arrives on the CPU, in every run and
on either tier; a step moves what it needs to its own card
(``granted_cuda_device()``).  Without the rule a thread-tier step would
hand its tensors on by reference, on the card, in a first run, and on the
host after a resume.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
)


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    CANCELED = "CANCELED"
    RESUMABLE = "RESUMABLE"


_storage_root: Optional[str] = None
_lock = threading.Lock()


def init_storage(path: str) -> None:
    """Set the workflow storage root (ref: workflow.init storage arg)."""
    global _storage_root
    _storage_root = os.path.abspath(path)
    os.makedirs(_storage_root, exist_ok=True)


def _root() -> str:
    global _storage_root
    if _storage_root is None:
        init_storage(os.environ.get(
            "RAY_TPU_WORKFLOW_ROOT",
            os.path.join(os.path.expanduser("~"), ".ray_tpu_torch",
                         "workflows")))
    return _storage_root


_WF_ID_RE = None


def _wf_dir(workflow_id: str) -> str:
    global _WF_ID_RE
    if _WF_ID_RE is None:
        import re

        # No separators, no "..": ids must stay inside the storage root
        # (delete("..") would otherwise rmtree the root's parent).
        _WF_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")
    if not _WF_ID_RE.match(workflow_id) or ".." in workflow_id:
        raise ValueError(f"invalid workflow id: {workflow_id!r}")
    return os.path.join(_root(), workflow_id)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_meta(wf_dir: str, **updates) -> dict:
    meta_path = os.path.join(wf_dir, "workflow.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta.update(updates)
    _atomic_write(meta_path, json.dumps(meta, indent=2).encode())
    return meta


def _read_meta(wf_dir: str) -> dict:
    with open(os.path.join(wf_dir, "workflow.json")) as f:
        return json.load(f)


# ----------------------------------------------------------------- step ids
def _const_digest(h, value) -> None:
    # Primitives digest via repr; everything else via pickle bytes — a
    # default object repr embeds the memory address, which would change the
    # step id across processes and silently break resume's exactly-once
    # replay.  Unpicklable constants fail loudly (the DAG must pickle for
    # dag.pkl anyway).
    if isinstance(value, (str, int, float, bool, bytes, type(None))):
        h.update(repr(value).encode())
    else:
        h.update(serialization.dumps(value))


def _step_ids(dag: DAGNode) -> Dict[int, str]:
    """Content-derived step id per node: function identity + constant args +
    upstream ids (ref: workflow_state_from_dag.py deterministic step names)."""
    ids: Dict[int, str] = {}
    for node in dag._topo():
        h = hashlib.sha1()
        if isinstance(node, InputNode):
            h.update(b"input")
        elif isinstance(node, InputAttributeNode):
            h.update(f"input[{node._key!r}]".encode())
        elif isinstance(node, FunctionNode):
            fn = node._remote_fn._function
            h.update(f"{fn.__module__}.{fn.__qualname__}".encode())
            code = getattr(fn, "__code__", None)
            if code is not None:
                h.update(code.co_code)
        else:
            raise TypeError(
                f"workflows support function steps and InputNode, got "
                f"{type(node).__name__} (actor nodes are not durable)")
        for a in node._bound_args:
            if isinstance(a, DAGNode):
                h.update(ids[id(a)].encode())
            else:
                _const_digest(h, a)
        for k in sorted(node._bound_kwargs):
            v = node._bound_kwargs[k]
            h.update(k.encode())
            if isinstance(v, DAGNode):
                h.update(ids[id(v)].encode())
            else:
                _const_digest(h, v)
        ids[id(node)] = h.hexdigest()[:16]
    # Disambiguate identical bind() calls (same fn, same args): they are
    # distinct steps — sharing one checkpoint would replay one draw of a
    # non-deterministic step as both.  Topo order is deterministic for a
    # given DAG, so the occurrence suffix is stable across resume.
    seen: Dict[str, int] = {}
    for node in dag._topo():
        base = ids[id(node)]
        n = seen.get(base, 0)
        seen[base] = n + 1
        if n:
            ids[id(node)] = f"{base}-{n}"
    return ids


# ---------------------------------------------------------------- execution
def _run_step_and_checkpoint(ckpt_path: str, fn, *args, **kwargs):
    """Runs INSIDE the step task: the checkpoint is durably written before
    the step's result becomes visible to any downstream step, so a driver
    (or downstream) crash can never lose a completed step — the
    exactly-once property resume depends on.  The result handed on is the
    checkpoint's value (the module docstring's device rule)."""
    blob = serialization.dumps(fn(*args, **kwargs))
    _atomic_write(ckpt_path, blob)
    return serialization.loads(blob)


def _execute(wf_dir: str, dag: DAGNode, input_args: tuple,
             input_kwargs: dict) -> Any:
    import ray_tpu_torch

    steps_dir = os.path.join(wf_dir, "steps")
    os.makedirs(steps_dir, exist_ok=True)
    ids = _step_ids(dag)
    order = dag._topo()

    # Pass 1: per node, either load its checkpoint or submit it (wrapped in
    # the checkpoint runner) with its upstream refs/values — independent
    # branches run in parallel, and ObjectRef args are resolved by the
    # runtime before execution.
    pending: Dict[int, Any] = {}  # id(node) -> ObjectRef
    values: Dict[int, Any] = {}   # id(node) -> concrete value

    def resolved(node):
        args = tuple(
            values[id(a)] if isinstance(a, DAGNode) and id(a) in values
            else pending[id(a)] if isinstance(a, DAGNode) else a
            for a in node._bound_args)
        kwargs = {
            k: (values[id(v)] if isinstance(v, DAGNode) and id(v) in values
                else pending[id(v)] if isinstance(v, DAGNode) else v)
            for k, v in node._bound_kwargs.items()}
        return args, kwargs

    from ray_tpu_torch.remote_function import RemoteFunction

    for node in order:
        if isinstance(node, InputNode):
            values[id(node)] = node._execute_impl({}, input_args, input_kwargs)
        elif isinstance(node, InputAttributeNode):
            values[id(node)] = (input_args[node._key]
                                if isinstance(node._key, int)
                                else input_kwargs[node._key])
        else:  # FunctionNode
            ckpt = os.path.join(steps_dir, f"{ids[id(node)]}.pkl")
            if os.path.exists(ckpt):
                with open(ckpt, "rb") as f:
                    values[id(node)] = serialization.loads(f.read())
                continue
            args, kwargs = resolved(node)
            runner = RemoteFunction(_run_step_and_checkpoint,
                                    dict(node._remote_fn._default_options))
            pending[id(node)] = runner.remote(
                ckpt, node._remote_fn._function, *args, **kwargs)

    # Pass 2: drain in topo order (results were checkpointed step-side).
    for node in order:
        if id(node) in values or id(node) not in pending:
            continue
        if os.path.exists(os.path.join(wf_dir, "cancel")):
            _write_meta(wf_dir, status=WorkflowStatus.CANCELED,
                        finished_at=time.time())
            raise WorkflowCancelledError(os.path.basename(wf_dir))
        values[id(node)] = ray_tpu_torch.get(pending.pop(id(node)))

    return values[id(dag)]


class WorkflowCancelledError(RuntimeError):
    pass


def _run_persisted(wf_dir: str) -> Any:
    """Execute (or re-execute) from the persisted DAG + inputs."""
    with open(os.path.join(wf_dir, "dag.pkl"), "rb") as f:
        dag, input_args, input_kwargs = serialization.loads(f.read())
    _write_meta(wf_dir, status=WorkflowStatus.RUNNING, started_at=time.time())
    try:
        result = _execute(wf_dir, dag, input_args, input_kwargs)
    except WorkflowCancelledError:
        raise
    except BaseException as e:  # noqa: BLE001
        _write_meta(wf_dir, status=WorkflowStatus.FAILED, error=repr(e),
                    finished_at=time.time())
        raise
    _atomic_write(os.path.join(wf_dir, "output.pkl"),
                  serialization.dumps(result))
    _write_meta(wf_dir, status=WorkflowStatus.SUCCESSFUL,
                finished_at=time.time())
    return result


# ---------------------------------------------------------------- public API
def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        **kwargs) -> Any:
    """Run a DAG durably; blocks until the result (ref: workflow.run)."""
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
    _step_ids(dag)  # validate the DAG (rejects actor nodes) before persisting
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    # Persist the program before executing, so a crashed run is resumable.
    _atomic_write(os.path.join(wf_dir, "dag.pkl"),
                  serialization.dumps((dag, args, kwargs)))
    _write_meta(wf_dir, workflow_id=workflow_id, created_at=time.time(),
                status=WorkflowStatus.RUNNING)
    return _run_persisted(wf_dir)


def run_async(dag: DAGNode, *args, workflow_id: Optional[str] = None,
              **kwargs):
    """Like run() but returns a concurrent.futures.Future."""
    import concurrent.futures

    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(run, dag, *args, workflow_id=workflow_id, **kwargs)
    fut.workflow_id = workflow_id  # type: ignore[attr-defined]
    ex.shutdown(wait=False)
    return fut


def resume(workflow_id: str) -> Any:
    """Resume a crashed/failed/canceled workflow: finished steps replay from
    their checkpoints; only unfinished steps execute (ref: workflow.resume)."""
    wf_dir = _wf_dir(workflow_id)
    if not os.path.exists(os.path.join(wf_dir, "dag.pkl")):
        raise ValueError(f"no such workflow: {workflow_id}")
    cancel_marker = os.path.join(wf_dir, "cancel")
    if os.path.exists(cancel_marker):
        os.remove(cancel_marker)
    return _run_persisted(wf_dir)


def get_status(workflow_id: str) -> str:
    return _read_meta(_wf_dir(workflow_id))["status"]


def get_output(workflow_id: str) -> Any:
    """The persisted final result of a successful run."""
    out = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(out):
        status = get_status(workflow_id)
        raise ValueError(
            f"workflow {workflow_id} has no output (status={status})")
    with open(out, "rb") as f:
        return serialization.loads(f.read())


def list_all(status_filter: Optional[str] = None) -> List[Tuple[str, str]]:
    """[(workflow_id, status)] (ref: workflow.list_all)."""
    out = []
    root = _root()
    for wf_id in sorted(os.listdir(root)):
        meta_path = os.path.join(root, wf_id, "workflow.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            status = json.load(f).get("status", "UNKNOWN")
        if status_filter is None or status == status_filter:
            out.append((wf_id, status))
    return out


def cancel(workflow_id: str) -> None:
    """Request cancellation: the executor stops before its next step and
    marks the workflow CANCELED (running steps finish)."""
    wf_dir = _wf_dir(workflow_id)
    if not os.path.isdir(wf_dir):
        raise ValueError(f"no such workflow: {workflow_id}")
    with open(os.path.join(wf_dir, "cancel"), "w") as f:
        f.write(str(time.time()))


def delete(workflow_id: str) -> None:
    import shutil

    wf_dir = _wf_dir(workflow_id)
    if os.path.isdir(wf_dir):
        shutil.rmtree(wf_dir)
