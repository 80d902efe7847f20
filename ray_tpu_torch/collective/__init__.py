"""ray_tpu_torch.collective — collective communication between ranks (the
counterpart of ``ray_tpu.collective``).

API-compatible with the reference's ``ray.util.collective``
(ref: python/ray/util/collective/collective.py — GroupManager:40,
init_collective_group:120, allreduce:258, reduce:311, broadcast:373,
allgather:423, reducescatter:472, send:531, recv:594). Two tiers behind one
call surface, chosen as the reference chooses them: ranks that are threads
of one process rendezvous in-process (``thread_group.py``), and ranks that
are the processes of one ``torch.distributed`` group (one rank per
process, ``distributed.initialize``) run each op as a process-group call,
NCCL on their cards or gloo on the CPU (``process_group.py``). Backends are
``"nccl"`` (the default) and ``"gloo"``; any other name raises. The
transport is the process group's, which ``distributed.initialize`` chose
(NCCL when the rank holds a card, gloo on the host): ``"gloo"`` on a rank
whose process group is NCCL raises rather than run over NCCL, and
``"nccl"`` on a host-only rank runs over its gloo group. The thread tier
has no transport (its ops run in-process on the contributions' device),
so there the name is the reference's API and chooses nothing. Rank
identity comes from the calling actor or task's declared rank (passed at
init), exactly like the reference.

``torch.distributed`` is imported only by the process tier's functions:
importing this package sets up no process group.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.collective.thread_group import ReduceOp, ThreadCollectiveGroup

BACKENDS = ("nccl", "gloo")

_local = threading.local()


class GroupManager:
    """(ref: collective.py:40 GroupManager)"""

    def __init__(self) -> None:
        self._groups: Dict[str, Any] = {}
        # Rank bindings per (group, actor_id): an actor's methods may run on
        # different threads than its __init__, so rank identity hangs off the
        # actor, with thread-local as the fallback for plain tasks.
        self._actor_ranks: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def bind_actor_rank(self, group_name: str, actor_id: str, rank: int) -> None:
        with self._lock:
            self._actor_ranks[(group_name, actor_id)] = rank

    def actor_rank(self, group_name: str, actor_id: str) -> Optional[int]:
        return self._actor_ranks.get((group_name, actor_id))

    def create_group(self, group_name: str, world_size: int,
                     devices: Optional[List[Any]] = None,
                     timeout_s=None, backend: str = "nccl"):
        with self._lock:
            group = self._groups.get(group_name)
            if group is None:
                from ray_tpu_torch.collective.process_group import (
                    ProcessCollectiveGroup,
                    multiprocess_world,
                )

                # One rank per process of a torch.distributed group
                # (world_size == its size, 1 included): ops are
                # process-group calls, since the other ranks live in other
                # processes. Any other layout (ranks that are threads of
                # this process) keeps the in-process tier.
                nproc = multiprocess_world()
                if nproc >= 1 and world_size == nproc:
                    group = ProcessCollectiveGroup(group_name, world_size,
                                                   devices, timeout_s=timeout_s)
                    if backend == "gloo" and group.backend == "nccl":
                        raise ValueError(
                            f"Group '{group_name}': backend 'gloo' asked on "
                            f"a rank whose process group is NCCL on its "
                            f"card; join with distributed.initialize(..., "
                            f"backend='gloo') to run it over gloo")
                else:
                    group = ThreadCollectiveGroup(group_name, world_size,
                                                  devices, timeout_s=timeout_s)
                self._groups[group_name] = group
            elif group.world_size != world_size:
                raise ValueError(
                    f"Group '{group_name}' exists with world_size={group.world_size}")
            elif timeout_s is not None:
                # Group already made by another rank: honour the explicit
                # per-group override anyway.
                group.timeout_s = float(timeout_s)
            return group

    def get_group(self, group_name: str):
        group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"Collective group '{group_name}' is not initialized; call "
                f"init_collective_group() in every participating worker first.")
        return group

    def destroy_group(self, group_name: str) -> None:
        with self._lock:
            group = self._groups.pop(group_name, None)
            if group is not None:
                group.destroy()
            for key in [k for k in self._actor_ranks if k[0] == group_name]:
                del self._actor_ranks[key]

    def reform_group(self, group_name: str, world_size: int,
                     backend: str = "nccl", timeout_s=None):
        """Re-form a group at a new world size: the old group is destroyed
        (waking every rank blocked in one of its rendezvous with an error),
        its actor-rank bindings dropped, and a fresh group takes its name."""
        with self._lock:
            group = self._groups.pop(group_name, None)
            if group is not None:
                group.destroy()
            for key in [k for k in self._actor_ranks if k[0] == group_name]:
                del self._actor_ranks[key]
        return self.create_group(group_name, world_size, timeout_s=timeout_s,
                                 backend=backend)


_manager = GroupManager()


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(
            f"Unsupported backend '{backend}'; the port's backends are "
            f"{BACKENDS}")


def _ctx_rank(group_name: str, rank: Optional[int], group=None) -> int:
    if rank is not None:
        return rank
    if getattr(group, "rank", None) is not None:
        return group.rank  # a process group: the rank is the process's
    from ray_tpu_torch._private.runtime import current_task_context

    ctx = current_task_context()
    if ctx is not None and ctx.actor_id is not None:
        bound = _manager.actor_rank(group_name, str(ctx.actor_id))
        if bound is not None:
            return bound
    ranks = getattr(_local, "ranks", None)
    if ranks is None or group_name not in ranks:
        raise ValueError(
            "No rank bound for this worker. Actors: call init_collective_group "
            "in __init__ (binding is per-actor). Plain tasks: init and use the "
            "collective within the SAME task call, or pass rank= explicitly — "
            "task-thread bindings do not persist across task invocations.")
    return ranks[group_name]


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default",
                          timeout_s=None) -> None:
    """Declare this worker a member of the group (ref: collective.py:120).

    The group is made on first use and the calling actor (or thread) is
    bound to ``rank``. When this process is one rank of a
    ``torch.distributed`` group of ``world_size`` processes, the group's
    ops are that process group's calls; otherwise the ranks are threads of
    this process and rendezvous in it."""
    _check_backend(backend)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    _manager.create_group(group_name, world_size, timeout_s=timeout_s,
                          backend=backend)
    from ray_tpu_torch._private.runtime import current_task_context

    ctx = current_task_context()
    if ctx is not None and ctx.actor_id is not None:
        _manager.bind_actor_rank(group_name, str(ctx.actor_id), rank)
    if getattr(_local, "ranks", None) is None:
        _local.ranks = {}
    _local.ranks[group_name] = rank


def create_collective_group(actors: List[Any], world_size: int, ranks: List[int],
                            backend: str = "nccl", group_name: str = "default",
                            timeout_s=None) -> None:
    """Driver-side declaration for a set of actors (ref: collective.py:151):
    binds each actor's identity to its rank in the group manager."""
    _check_backend(backend)
    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must have the same length")
    _manager.create_group(group_name, world_size, timeout_s=timeout_s,
                          backend=backend)
    for actor, rank in zip(actors, ranks):
        _manager.bind_actor_rank(group_name, str(actor._ray_actor_id), rank)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy_group(group_name)


def reform_collective_group(world_size: int, group_name: str = "default",
                            backend: str = "nccl", timeout_s=None) -> None:
    """Re-form ``group_name`` at a new world size; blocked ranks of the old
    group wake with an error, and members re-bind through
    init_collective_group."""
    _check_backend(backend)
    _manager.reform_group(group_name, world_size, backend=backend,
                          timeout_s=timeout_s)


def get_collective_group(group_name: str = "default"):
    return _manager.get_group(group_name)


def allreduce(tensor: Any, group_name: str = "default", op: str = ReduceOp.SUM,
              rank: Optional[int] = None) -> Any:
    """(ref: collective.py:258)"""
    group = _manager.get_group(group_name)
    return group.allreduce(_ctx_rank(group_name, rank, group), tensor, op)


def reduce(tensor: Any, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM, rank: Optional[int] = None) -> Any:
    """(ref: collective.py:311) — allreduce, kept on ``dst_rank``."""
    group = _manager.get_group(group_name)
    r = _ctx_rank(group_name, rank, group)
    out = group.allreduce(r, tensor, op)
    return out if r == dst_rank else tensor


def broadcast(tensor: Any, src_rank: int = 0, group_name: str = "default",
              rank: Optional[int] = None) -> Any:
    """(ref: collective.py:373)"""
    group = _manager.get_group(group_name)
    return group.broadcast(_ctx_rank(group_name, rank, group), tensor, src_rank)


def allgather(tensor: Any, group_name: str = "default",
              rank: Optional[int] = None) -> Any:
    """(ref: collective.py:423) — returns the stacked (world_size, ...) tensor."""
    group = _manager.get_group(group_name)
    return group.allgather(_ctx_rank(group_name, rank, group), tensor)


def reducescatter(tensor: Any, group_name: str = "default", op: str = ReduceOp.SUM,
                  rank: Optional[int] = None) -> Any:
    """(ref: collective.py:472) — input dim0 must equal world_size."""
    group = _manager.get_group(group_name)
    return group.reducescatter(_ctx_rank(group_name, rank, group), tensor, op)


def send(tensor: Any, dst_rank: int, group_name: str = "default",
         rank: Optional[int] = None) -> Any:
    """(ref: collective.py:531) — paired with recv as one round."""
    group = _manager.get_group(group_name)
    r = _ctx_rank(group_name, rank, group)
    return group.send_recv(r, tensor, [(r, dst_rank)])


def recv(tensor: Any, src_rank: int, group_name: str = "default",
         rank: Optional[int] = None) -> Any:
    """(ref: collective.py:594)"""
    group = _manager.get_group(group_name)
    r = _ctx_rank(group_name, rank, group)
    return group.send_recv(r, tensor, [(src_rank, r)])


def barrier(group_name: str = "default", rank: Optional[int] = None) -> None:
    group = _manager.get_group(group_name)
    group.barrier(_ctx_rank(group_name, rank, group))


__all__ = [
    "BACKENDS", "ReduceOp", "init_collective_group", "create_collective_group",
    "destroy_collective_group", "reform_collective_group",
    "get_collective_group", "allreduce", "reduce",
    "broadcast", "allgather", "reducescatter", "send", "recv", "barrier",
]
