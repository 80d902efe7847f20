"""Process-tier collective group: one rank per process, over the process
group that ``distributed.initialize`` joined.

The counterpart of ``ray_tpu/collective/dcn_group.py``
(``DCNCollectiveGroup``, whose ops are global SPMD programs over
``jax.distributed``; ref: nccl_collective_group.py and
gloo_collective_group.py). Here each op is a ``torch.distributed`` call on
the default group: NCCL on the rank's card, gloo on the CPU. The same call
surface as the thread tier (rank, tensor), and the same SPMD contract as
NCCL: every rank issues the same sequence of collectives, and a rank that
skips one deadlocks the others. ``send_recv`` involves only the ranks in
its ``perm``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.collective.thread_group import ReduceOp, as_tensor


def multiprocess_world() -> int:
    """The process group's world size, 0 when this process joined none."""
    from ray_tpu_torch.collective import distributed

    return distributed.process_count() if distributed.is_initialized() else 0


def _dist_op(op: str):
    import torch.distributed as dist

    ops = {ReduceOp.SUM: dist.ReduceOp.SUM,
           ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
           ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"Unknown reduce op: {op}")
    return ops[op]


class ProcessCollectiveGroup:
    """One collective group across the processes of the process group."""

    def __init__(self, group_name: str, world_size: int,
                 devices: Optional[List[Any]] = None,
                 timeout_s: Optional[float] = None):
        import torch
        import torch.distributed as dist

        nproc = multiprocess_world()
        if world_size != nproc:
            raise ValueError(
                f"multi-process collective group '{group_name}': world_size "
                f"{world_size} must equal the process group's {nproc} (one "
                f"rank per process; for several ranks in one process use "
                f"the thread tier)")
        self.group_name = group_name
        self.world_size = world_size
        self.timeout_s = timeout_s
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        #: Where the ops run: this rank's card under NCCL, else the host.
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))
        self._lock = threading.Lock()
        #: Ops issued by this rank, by name (a run reads that its gradient
        #: all-reduce went through the group).
        self.ops: Dict[str, int] = {}

    def _check_rank(self, rank: int) -> None:
        if rank != self.rank:
            raise ValueError(
                f"rank {rank} called a collective from process rank "
                f"{self.rank}: in a process group the rank IS the process's")

    def _count(self, op: str) -> None:
        with self._lock:
            self.ops[op] = self.ops.get(op, 0) + 1

    def _work(self, rank: int, array: Any, op: str):
        self._check_rank(rank)
        self._count(op)
        t = as_tensor(array)
        return t, t.to(self.device, copy=True)

    # --------------------------------------------------------- collectives
    def allreduce(self, rank: int, array: Any, op: str = ReduceOp.SUM) -> Any:
        import torch.distributed as dist

        t, x = self._work(rank, array, "allreduce")
        dist.all_reduce(x, op=_dist_op(op))
        return x.to(t.device)

    def allgather(self, rank: int, array: Any) -> Any:
        import torch
        import torch.distributed as dist

        t, x = self._work(rank, array, "allgather")
        out = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(out, x)
        return torch.stack(out).to(t.device)

    def reducescatter(self, rank: int, array: Any, op: str = ReduceOp.SUM) -> Any:
        """An all-reduce of the (world, ...) input, then this rank's row
        (gloo has no reduce-scatter of its own)."""
        import torch.distributed as dist

        t, x = self._work(rank, array, "reducescatter")
        if x.shape[0] != self.world_size:
            raise ValueError(
                f"reducescatter input dim0 ({x.shape[0]}) must equal "
                f"world_size ({self.world_size})")
        dist.all_reduce(x, op=_dist_op(op))
        return x[rank].to(t.device, copy=True)

    def broadcast(self, rank: int, array: Any, src_rank: int = 0) -> Any:
        import torch.distributed as dist

        t, x = self._work(rank, array, "broadcast")
        dist.broadcast(x, src=src_rank)
        return x.to(t.device)

    def barrier(self, rank: int) -> None:
        import torch

        self.allreduce(rank, torch.zeros(1))

    def send_recv(self, rank: int, array: Any, perm: List[Tuple[int, int]]) -> Any:
        """Each (src, dst) of ``perm`` moves src's tensor to dst in one
        batch of point-to-point ops; a participant that receives nothing
        gets zeros."""
        import torch
        import torch.distributed as dist

        participants = sorted({r for pair in perm for r in pair})
        if rank not in participants:
            raise ValueError(f"rank {rank} is not part of perm {perm}")
        t, x = self._work(rank, array, "send_recv")
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if rank == src:
                ops.append(dist.P2POp(dist.isend, x, dst))
            if rank == dst:
                ops.append(dist.P2POp(dist.irecv, out, src))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(t.device)

    def destroy(self) -> None:
        """The process group outlives the group: ``distributed.shutdown``
        leaves it."""
