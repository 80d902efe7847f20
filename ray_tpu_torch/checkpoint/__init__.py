"""ray_tpu_torch.checkpoint — asynchronous distributed checkpointing (the
counterpart of ``ray_tpu.checkpoint``; the same on-disk layout).

* ``ShardWriter.save_async``   — device->host snapshot into page-locked
  buffers on the step boundary, persist + commit on a background thread
  (Check-N-Run).
* ``CheckpointCoordinator``    — sharded two-phase commit: every shard
  lands under ``checkpoint_NNNNNN.tmp/`` with its manifest, then one
  atomic rename + ``COMMIT`` marker makes the step visible.
* in-memory replica tier       — last-k step snapshots pinned in the
  object store (Gemini); the peer-node mirror waits for the port's
  virtual nodes (ROADMAP.md, Queue 1 item 13.8a).
* ``restore_pytree`` / ``reshard_tree`` — restore from any committed
  step, written at any world size, onto a device;
  ``restore_from_payloads`` the same from the memory replicas.

Chaos fault points: ``ckpt_shard_write``, ``ckpt_commit``,
``ckpt_restore`` (ray_tpu_torch._private.fault_injection).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ray_tpu_torch.checkpoint import layout
from ray_tpu_torch.checkpoint import metrics as ckpt_metrics
from ray_tpu_torch.checkpoint.coordinator import CheckpointCoordinator
from ray_tpu_torch.checkpoint.elastic import reshard_tree
from ray_tpu_torch.checkpoint.layout import (
    is_committed_dir,
    latest_committed_step,
    list_committed_steps,
)
from ray_tpu_torch.checkpoint.replica import ReplicaHolder
from ray_tpu_torch.checkpoint.writer import (
    PinnedPool,
    SaveHandle,
    ShardWriter,
    snapshot_to_host,
)

__all__ = [
    "CheckpointCoordinator", "PinnedPool", "ReplicaHolder", "SaveHandle",
    "ShardWriter", "is_committed_dir", "latest_committed_step",
    "list_committed_steps", "materialize_from_payloads", "reshard_tree",
    "restore_from_payloads", "restore_latest", "restore_pytree",
    "snapshot_to_host",
]


def restore_pytree(path: str, template: Optional[Any] = None, *,
                   device=None, mesh=None, pspec=None, pspec_fn=None,
                   _source: str = "disk") -> Any:
    """Restore the full tree from one *committed* checkpoint directory.

    Without ``template`` or ``device`` the leaves are torch tensors on the
    host (bfloat16 ones bit for bit). ``template`` (a tree of the same
    structure, checked) puts each leaf on its template leaf's device and
    dtype, ``device`` on one device, ``mesh`` (with ``pspec`` or
    ``pspec_fn``) shards each leaf over a device mesh as DTensors
    (``reshard_tree``); the writer's world size never has to match."""
    from ray_tpu_torch._private import fault_injection
    from ray_tpu_torch.util import tracing

    t0 = time.monotonic()
    with tracing.span("checkpoint.restore",
                      attributes={"path": path, "source": _source}):
        fault_injection.check("ckpt_restore")
        if not layout.is_committed_dir(path):
            raise ValueError(
                f"{path} is not a committed checkpoint (missing COMMIT "
                "marker or non-final name) — refusing to restore a "
                "potentially torn directory")
        tree = layout.assemble_tree(path)
        if template is not None:
            _check_template(tree, template)
        if template is not None or device is not None or mesh is not None \
                or pspec is not None or pspec_fn is not None:
            tree = reshard_tree(tree, mesh, pspec=pspec, pspec_fn=pspec_fn,
                                device=device, template=template)
    ckpt_metrics.RESTORES.inc(tags={"source": _source})
    ckpt_metrics.RESTORE_SECONDS.observe(time.monotonic() - t0,
                                         tags={"source": _source})
    return tree


def restore_latest(root: str, template: Optional[Any] = None, *,
                   device=None, mesh=None, pspec=None, pspec_fn=None
                   ) -> Optional[Any]:
    """Restore from the latest committed step under ``root`` (e.g. a serve
    deployment loading model weights); None when nothing is committed."""
    step = layout.latest_committed_step(root)
    if step is None:
        return None
    return restore_pytree(layout.final_dir(root, step), template,
                          device=device, mesh=mesh, pspec=pspec,
                          pspec_fn=pspec_fn)


def restore_from_payloads(payloads: Dict[int, dict],
                          template: Optional[Any] = None, *,
                          device=None) -> Any:
    """Restore the full tree from one step's in-memory replica payloads
    (shard id -> payload), as ``restore_pytree`` does from its committed
    dir: no file is written or read. The leaves own their bytes (the
    payloads stay whole). Observes the restore's seconds under
    ``source="memory"``; the caller that chose the replicas counts the
    restore (``ray_tpu_ckpt_restores_total``)."""
    from ray_tpu_torch._private import fault_injection
    from ray_tpu_torch.util import tracing

    t0 = time.monotonic()
    with tracing.span("checkpoint.restore",
                      attributes={"step": payloads[0]["step"],
                                  "source": "memory"}):
        fault_injection.check("ckpt_restore")
        tree = layout.assemble_from_payloads(payloads)
        if template is not None:
            _check_template(tree, template)
        if template is not None or device is not None:
            tree = reshard_tree(tree, device=device, template=template)
    ckpt_metrics.RESTORE_SECONDS.observe(time.monotonic() - t0,
                                         tags={"source": "memory"})
    return tree


def materialize_from_payloads(root: str, step: int,
                              payloads: Dict[int, dict]) -> str:
    """Write a committed checkpoint dir from in-memory replica payloads
    (fast restore without touching the original storage); returns the
    committed path."""
    return layout.write_committed_from_payloads(root, step, payloads)


def _check_template(tree: Any, template: Any) -> None:
    """The torch pytree structures must be equal, dict keys compared as
    sets (a restored dict's keys come back sorted)."""
    from torch.utils import _pytree

    from ray_tpu_torch.checkpoint.elastic import align

    want = _pytree.tree_structure(template)
    try:
        got = _pytree.tree_structure(align(tree, template))
    except ValueError:
        got = _pytree.tree_structure(tree)
    if got != want:
        raise ValueError(
            f"restored tree structure {got} does not match template {want}")
