"""Joining one ``torch.distributed`` process group: the process tier's
bootstrap (the counterpart of ``ray_tpu/collective/distributed.py``, which
joins ``jax.distributed``; ref: python/ray/train/torch/config.py:66
_setup_torch_process_group).

Each rank is a process. ``initialize(address, world, rank)`` joins the
group through a TCP store at rank 0's ``address``: NCCL when this process
holds a card (it selects the card first), gloo on the CPU.
``auto_initialize`` reads the reference's environment:

  RAY_TPU_COORDINATOR   host:port of rank 0
  RAY_TPU_NUM_PROCESSES world size
  RAY_TPU_PROCESS_ID    this process's rank

``torch.distributed`` is imported by the functions that use it, so
importing this module sets up nothing.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Optional

#: Bound on the rendezvous: a probed port is TOCTOU-racy (another process
#: can take it between probe and bind), and without a bound every rank
#: would wait out torch's 30-minute default.
INIT_TIMEOUT_S = 120.0


def default_backend() -> str:
    """NCCL when this process holds a card, gloo otherwise."""
    import torch

    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None) -> str:
    """Join the process group (once per process); returns its backend. A
    rank with a card selects it (its lease's, through
    ``granted_cuda_device``) before NCCL binds to it."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or default_backend()
    kwargs = {}
    if backend == "nccl":
        from ray_tpu_torch._private.device import granted_cuda_device

        dev = granted_cuda_device()
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=INIT_TIMEOUT_S), **kwargs)
    return backend


def auto_initialize() -> bool:
    """Initialize from RAY_TPU_COORDINATOR/... when they are set (the
    trainer's worker start calls this on every worker)."""
    addr = os.environ.get("RAY_TPU_COORDINATOR")
    if not addr:
        return False
    initialize(addr, int(os.environ["RAY_TPU_NUM_PROCESSES"]),
               int(os.environ["RAY_TPU_PROCESS_ID"]))
    return True


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def local_batch_to_global(mesh, local_batch: Any, axis: str = "data"):
    """Assemble each process's batch shard into one global batch sharded
    over ``axis`` of ``mesh`` (a ``parallel.Mesh`` over the process group):
    a DTensor whose rows are the ranks' rows in mesh order, replicated over
    the other axes, so ranks that differ only there pass the same rows.
    ``axis`` is a mesh axis name or, as in a PartitionSpec entry, a tuple
    of them (major to minor: ``("data", "fsdp")`` is the batch's), or a
    whole ``PartitionSpec`` with one entry per dimension:
    ``batch_sharding(mesh).spec`` gives each rank its (B/data, S/seq)
    block of tokens. Nothing is sent (``DTensor.from_local``)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import (PartitionSpec, make_mesh,
                                             spec_to_placements)

    mesh = make_mesh(mesh)
    local = local_batch if isinstance(local_batch, torch.Tensor) \
        else torch.as_tensor(np.asarray(local_batch))
    dm = mesh.device_mesh
    spec = axis if isinstance(axis, PartitionSpec) else PartitionSpec(axis)
    return DTensor.from_local(local.to(dm.device_type), dm,
                              spec_to_placements(spec, mesh),
                              run_check=False)
