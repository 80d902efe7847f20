"""The resources of the one node the thread tier runs on (the counterpart of
``ray_tpu/_private/scheduling.py``; ref: src/ray/raylet/scheduling/
cluster_resource_scheduler.h:44).

The node holds ``CPU``, ``GPU``, ``memory`` and custom resources. A request
is granted when it fits what is free now, waits while it fits only the
node's totals, and is infeasible when it exceeds them. A lease that holds
GPUs names the device indices it was granted (ref: ray.get_gpu_ids), so
each replica on a host with several cards runs on its own: a fraction of a
GPU shares one index, a whole number of GPUs takes that many free indices.

The reference's placement policies (hybrid pack/spread, SPREAD, node
affinity, node labels) choose among nodes and come with the multi-node
runtime (ROADMAP.md, Queue 1); on one node a ``scheduling_strategy`` option
changes nothing and is ignored. Placement groups are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

Resources = Dict[str, float]

_EPS = 1e-9


def res_fits(avail: Resources, req: Resources) -> bool:
    return all(avail.get(k, 0.0) + _EPS >= v for k, v in req.items())


def res_sub(avail: Resources, req: Resources) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def res_add(avail: Resources, req: Resources) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


class InfeasibleError(RuntimeError):
    pass


class Lease:
    """Resources granted to one task or actor; ``gpu_ids`` are the device
    indices among them. While its task blocks in get, a lease lends its
    non-GPU resources back (``suspended``) and keeps its GPUs."""

    __slots__ = ("request", "gpu_ids", "released", "suspended")

    def __init__(self, request: Resources, gpu_ids: Tuple[int, ...]):
        self.request = request
        self.gpu_ids = gpu_ids
        self.released = False
        self.suspended = False


class NodeScheduler:
    """Resource bookkeeping of the node (ref: cluster_task_manager.h:42).
    ``acquire`` blocks until a lease is granted; ``try_acquire`` grants one
    or returns None; a release wakes both kinds of waiter."""

    def __init__(self, resources: Resources) -> None:
        gpus = resources.get("GPU", 0.0)
        if gpus != int(gpus):
            raise ValueError(f"the node's GPU count must be whole, got {gpus}")
        self.total: Resources = dict(resources)
        self._available: Resources = dict(resources)
        #: Free share of each GPU index.
        self._gpu_free: List[float] = [1.0] * int(gpus)
        self._lock = threading.Condition()
        #: Called (outside the lock) after every release, so the dispatcher
        #: retries blocked tasks exactly when capacity appears.
        self.on_release: Optional[Callable[[], None]] = None

    def available(self) -> Resources:
        with self._lock:
            return dict(self._available)

    def feasible(self, request: Resources) -> bool:
        """Could the node ever hold ``request`` (its totals, not what is
        free now)?"""
        return res_fits(self.total, request)

    # ---------------------------------------------------------------- leasing
    def acquire(self, request: Resources, timeout: Optional[float] = None) -> Lease:
        """Block until ``request`` is granted. Raises InfeasibleError for a
        request the node can never hold."""
        if not self.feasible(request):
            raise InfeasibleError(
                f"Resource request {request} is infeasible on this node "
                f"(total={self.total})")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                lease = self._grant_locked(request)
                if lease is not None:
                    return lease
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"Could not acquire {request} within timeout; "
                        f"available={self._available}")
                self._lock.wait(remaining if remaining is not None else 1.0)

    def try_acquire(self, request: Resources) -> Optional[Lease]:
        with self._lock:
            return self._grant_locked(request)

    def release(self, lease: Lease) -> None:
        """Return a lease's resources; a second release does nothing."""
        with self._lock:
            if lease.released:
                return
            lease.released = True
            res_add(self._available, _held(lease))
            for i in lease.gpu_ids:
                self._gpu_free[i] += lease.request["GPU"] / len(lease.gpu_ids)
            self._lock.notify_all()
        self._fire_on_release()

    def suspend(self, lease: Lease) -> None:
        """Lend a lease's non-GPU resources back while its task blocks in
        get; its GPUs stay its own (ref: the raylet releases a blocked
        worker's CPUs)."""
        with self._lock:
            if lease.released or lease.suspended:
                return
            lease.suspended = True
            res_add(self._available, _lendable(lease.request))
            self._lock.notify_all()
        self._fire_on_release()

    def resume(self, lease: Lease) -> None:
        """Take back what ``suspend`` lent, waiting until it is free."""
        part = _lendable(lease.request)
        with self._lock:
            if lease.released or not lease.suspended:
                return
            while not res_fits(self._available, part):
                self._lock.wait(1.0)
            res_sub(self._available, part)
            lease.suspended = False

    def _grant_locked(self, request: Resources) -> Optional[Lease]:
        if not res_fits(self._available, request):
            return None
        gpu_ids = self._pick_gpus(request.get("GPU", 0.0))
        if gpu_ids is None:
            return None
        for i in gpu_ids:
            self._gpu_free[i] -= request["GPU"] / len(gpu_ids)
        res_sub(self._available, request)
        return Lease(request, gpu_ids)

    def _pick_gpus(self, amount: float) -> Optional[Tuple[int, ...]]:
        """The indices for ``amount`` GPUs: a fraction takes the first index
        with that much free, a whole number that many unused indices."""
        if amount <= 0:
            return ()
        if amount < 1:
            free = [i for i, f in enumerate(self._gpu_free) if f + _EPS >= amount]
            return tuple(free[:1]) or None
        whole = [i for i, f in enumerate(self._gpu_free) if f + _EPS >= 1.0]
        n = int(amount)
        return tuple(whole[:n]) if len(whole) >= n else None

    def _fire_on_release(self) -> None:
        cb = self.on_release
        if cb is not None:
            cb()


def _lendable(request: Resources) -> Resources:
    return {k: v for k, v in request.items() if k != "GPU"}


def _held(lease: Lease) -> Resources:
    return _lendable(lease.request) if lease.suspended else lease.request
