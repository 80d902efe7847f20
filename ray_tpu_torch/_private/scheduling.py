"""The resources of the one node the thread tier runs on, and its placement
groups (the counterpart of ``ray_tpu/_private/scheduling.py``; ref:
src/ray/raylet/scheduling/cluster_resource_scheduler.h:44).

The node holds ``CPU``, ``GPU``, ``memory`` and custom resources. A request
is granted when it fits what is free now, waits while it fits only the
node's totals, and is infeasible when it exceeds them. A lease that holds
GPUs names the device indices it was granted (ref: ray.get_gpu_ids), so
each replica on a host with several cards runs on its own: a fraction of a
GPU shares one index, a whole number of GPUs takes that many free indices.

A placement group reserves its bundles all at once or not at all (the
reference's two-phase commit, ref: gcs_placement_group_scheduler); a
bundle's GPU share names its card indices, and a lease drawn from the
bundle (``PlacementGroupSchedulingStrategy``) takes its cards from those.
On one node PACK, SPREAD and STRICT_PACK place every bundle there, and
STRICT_SPREAD with more than one bundle stays pending, as the reference
leaves a group pending that no set of nodes can hold. A pending group is
retried whenever capacity comes back.

The reference's node policies (hybrid pack/spread, SPREAD, node affinity,
node labels) choose among nodes and come with the multi-node runtime
(ROADMAP.md, Queue 1 item 13.8): any other ``scheduling_strategy`` is
ignored here.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID

Resources = Dict[str, float]

_EPS = 1e-9

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


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


class SchedulingStrategy:
    """Base of the strategies given through ``options(scheduling_strategy=)``
    (ref: python/ray/util/scheduling_strategies.py)."""

    name = "DEFAULT"


class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    """Lease from bundle ``placement_group_bundle_index`` of a group, or
    from the first bundle with room when it is -1."""

    name = "PLACEMENT_GROUP"

    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.bundle_index = placement_group_bundle_index
        self.capture_child_tasks = placement_group_capture_child_tasks


class _Bundle:
    def __init__(self, index: int, resources: Resources):
        self.index = index
        self.resources = dict(resources)
        self.available = dict(resources)
        self.node_id: Optional[NodeID] = None
        #: Card index -> this bundle's free share of it (set at commit).
        self.gpu_free: Dict[int, float] = {}
        #: The shares of each card the bundle reserved from the node.
        self.gpu_reserved: Dict[int, float] = {}


class PlacementGroupState:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Resources],
                 strategy: str, name: str = ""):
        self.id = pg_id
        self.bundles = [_Bundle(i, b) for i, b in enumerate(bundles)]
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"
        self.ready_event = threading.Event()


class Lease:
    """Resources granted to one task or actor; ``gpu_ids`` are the device
    indices among them; ``bundle`` the placement-group bundle they come
    from (None: the node). While its task blocks in get, a lease lends its
    non-GPU resources back (``suspended``) and keeps its GPUs."""

    __slots__ = ("request", "gpu_ids", "released", "suspended", "bundle")

    def __init__(self, request: Resources, gpu_ids: Tuple[int, ...],
                 bundle: Optional[_Bundle] = None):
        self.request = request
        self.gpu_ids = gpu_ids
        self.released = False
        self.suspended = False
        self.bundle = bundle


def _pick_gpus(free: Dict[int, float], amount: float
               ) -> Optional[Tuple[int, ...]]:
    """The indices for ``amount`` GPUs among ``free`` (index -> free share):
    a fraction takes the first index with that much free, a whole number
    that many unused indices."""
    if amount <= 0:
        return ()
    if amount < 1:
        fits = [i for i, f in free.items() if f + _EPS >= amount]
        return tuple(fits[:1]) or None
    whole = [i for i, f in free.items() if f + _EPS >= 1.0]
    n = int(amount)
    return tuple(whole[:n]) if len(whole) >= n else None


def _take_gpus(free: Dict[int, float], ids: Tuple[int, ...], amount: float
               ) -> None:
    for i in ids:
        free[i] -= amount / len(ids)


class NodeScheduler:
    """Resource bookkeeping of the node (ref: cluster_task_manager.h:42).
    ``acquire`` blocks until a lease is granted; ``try_acquire`` grants one
    or returns None; a release wakes both kinds of waiter."""

    def __init__(self, resources: Resources,
                 node_id: Optional[NodeID] = None) -> None:
        gpus = resources.get("GPU", 0.0)
        if gpus != int(gpus):
            raise ValueError(f"the node's GPU count must be whole, got {gpus}")
        self.node_id = node_id if node_id is not None else NodeID.from_random()
        self.total: Resources = dict(resources)
        self._available: Resources = dict(resources)
        #: Free share of each GPU index.
        self._gpu_free: Dict[int, float] = {i: 1.0 for i in range(int(gpus))}
        self._pgs: Dict[PlacementGroupID, PlacementGroupState] = {}
        self._pg_pending: List[PlacementGroupState] = []
        self._lock = threading.Condition()
        #: Called (outside the lock) after every release, group commit and
        #: group removal, so the dispatcher retries blocked tasks exactly
        #: when capacity appears.
        self.on_release: Optional[Callable[[], None]] = None

    def available(self) -> Resources:
        with self._lock:
            return dict(self._available)

    def feasible(self, request: Resources,
                 strategy: Optional[SchedulingStrategy] = None) -> bool:
        """Could ``request`` ever be granted: within the node's totals, or
        within a bundle of the strategy's live placement group."""
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            with self._lock:
                pg = self._pgs.get(strategy.placement_group.id)
                if pg is None:
                    return False
                bundles = (pg.bundles if strategy.bundle_index < 0
                           else pg.bundles[strategy.bundle_index:
                                           strategy.bundle_index + 1])
                return any(res_fits(b.resources, request) for b in bundles)
        return res_fits(self.total, request)

    # ---------------------------------------------------------------- leasing
    def acquire(self, request: Resources, timeout: Optional[float] = None,
                strategy: Optional[SchedulingStrategy] = None) -> Lease:
        """Block until ``request`` is granted. Raises InfeasibleError for a
        request that can never be."""
        if not self.feasible(request, strategy):
            raise InfeasibleError(
                f"Resource request {request} is infeasible on this node "
                f"(total={self.total})")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                lease = self._grant_locked(request, strategy)
                if lease is not None:
                    return lease
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"Could not acquire {request} within timeout; "
                        f"available={self._available}")
                self._lock.wait(remaining if remaining is not None else 1.0)

    def try_acquire(self, request: Resources,
                    strategy: Optional[SchedulingStrategy] = None
                    ) -> Optional[Lease]:
        with self._lock:
            return self._grant_locked(request, strategy)

    def release(self, lease: Lease) -> None:
        """Return a lease's resources; a second release does nothing."""
        with self._lock:
            if lease.released:
                return
            lease.released = True
            avail, gpu_free = self._pools(lease)
            res_add(avail, _held(lease))
            for i in lease.gpu_ids:
                gpu_free[i] += lease.request["GPU"] / len(lease.gpu_ids)
            self._retry_pending_locked()
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
            res_add(self._pools(lease)[0], _lendable(lease.request))
            self._lock.notify_all()
        self._fire_on_release()

    def resume(self, lease: Lease) -> None:
        """Take back what ``suspend`` lent, waiting until it is free."""
        part = _lendable(lease.request)
        with self._lock:
            if lease.released or not lease.suspended:
                return
            avail = self._pools(lease)[0]
            while not res_fits(avail, part):
                self._lock.wait(1.0)
            res_sub(avail, part)
            lease.suspended = False

    def _pools(self, lease: Lease):
        """Where a lease's resources return: its bundle's, or the node's."""
        b = lease.bundle
        return ((self._available, self._gpu_free) if b is None
                else (b.available, b.gpu_free))

    def _grant_locked(self, request: Resources,
                      strategy: Optional[SchedulingStrategy]
                      ) -> Optional[Lease]:
        bundle = None
        avail, gpu_free = self._available, self._gpu_free
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            bundle = self._find_bundle(strategy, request)
            if bundle is None:
                return None
            avail, gpu_free = bundle.available, bundle.gpu_free
        if not res_fits(avail, request):
            return None
        gpu_ids = _pick_gpus(gpu_free, request.get("GPU", 0.0))
        if gpu_ids is None:
            return None
        _take_gpus(gpu_free, gpu_ids, request.get("GPU", 0.0))
        res_sub(avail, request)
        return Lease(request, gpu_ids, bundle)

    def _find_bundle(self, strategy: PlacementGroupSchedulingStrategy,
                     request: Resources) -> Optional[_Bundle]:
        pg = self._pgs.get(strategy.placement_group.id)
        if pg is None or pg.state != "CREATED":
            return None
        if strategy.bundle_index >= 0:
            b = pg.bundles[strategy.bundle_index]
            return b if res_fits(b.available, request) else None
        return next((b for b in pg.bundles
                     if res_fits(b.available, request)), None)

    def _fire_on_release(self) -> None:
        cb = self.on_release
        if cb is not None:
            cb()

    # ------------------------------------------------------- placement groups
    def create_placement_group(self, pg_id: PlacementGroupID,
                               bundles: List[Resources], strategy: str,
                               name: str = "") -> PlacementGroupState:
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}")
        pg = PlacementGroupState(pg_id, bundles, strategy, name)
        with self._lock:
            self._pgs[pg_id] = pg
            committed = self._try_commit_locked(pg)
            if not committed:
                self._pg_pending.append(pg)
        if committed:
            self._fire_on_release()
        return pg

    def _try_commit_locked(self, pg: PlacementGroupState) -> bool:
        """Reserve every bundle, or none (prepare on a scratch copy, then
        commit; ref: gcs_placement_group_scheduler's two phases)."""
        if pg.strategy == "STRICT_SPREAD" and len(pg.bundles) > 1:
            return False  # one node holds no two bundles apart
        avail = dict(self._available)
        gpu_free = dict(self._gpu_free)
        plan = []
        for b in pg.bundles:
            amount = b.resources.get("GPU", 0.0)
            ids = _pick_gpus(gpu_free, amount) if res_fits(avail, b.resources) \
                else None
            if ids is None:
                return False
            _take_gpus(gpu_free, ids, amount)
            res_sub(avail, b.resources)
            plan.append((b, ids, amount))
        self._available, self._gpu_free = avail, gpu_free
        for b, ids, amount in plan:
            b.node_id = self.node_id
            b.available = dict(b.resources)
            b.gpu_reserved = {i: amount / len(ids) for i in ids}
            b.gpu_free = dict(b.gpu_reserved)
        pg.state = "CREATED"
        pg.ready_event.set()
        self._lock.notify_all()
        return True

    def _retry_pending_locked(self) -> None:
        still = []
        for pg in self._pg_pending:
            if pg.state == "PENDING" and not self._try_commit_locked(pg):
                still.append(pg)
        self._pg_pending = still

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        """Give a group's bundles back to the node (leases still drawn from
        them return to nothing once released)."""
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            if pg is None:
                return
            if pg.state == "CREATED":
                for b in pg.bundles:
                    res_add(self._available, b.resources)
                    for i, share in b.gpu_reserved.items():
                        self._gpu_free[i] += share
            pg.state = "REMOVED"
            self._retry_pending_locked()
            self._lock.notify_all()
        self._fire_on_release()

    def get_placement_group(self, pg_id: PlacementGroupID
                            ) -> Optional[PlacementGroupState]:
        with self._lock:
            return self._pgs.get(pg_id)

    def placement_groups(self) -> List[PlacementGroupState]:
        with self._lock:
            return list(self._pgs.values())


def _lendable(request: Resources) -> Resources:
    return {k: v for k, v in request.items() if k != "GPU"}


def _held(lease: Lease) -> Resources:
    return _lendable(lease.request) if lease.suspended else lease.request
