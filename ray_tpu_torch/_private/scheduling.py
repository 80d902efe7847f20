"""The cluster's nodes, their resources and the policies that place work on
them (the counterpart of ``ray_tpu/_private/scheduling.py``; ref:
src/ray/raylet/scheduling/cluster_resource_scheduler.h:44 and policy/*.h).

The cluster is a set of nodes, the head and any virtual nodes
(``cluster_utils.Cluster``), each with ``CPU``, ``GPU``, ``memory`` and
custom resources and its labels. Execution stays in this process (threads,
or the worker processes of the process tier); the nodes make the
reference's multi-node placement real and testable on one host, as its
tests do through ``cluster_utils.Cluster``.

A node's GPUs are shares of the host's cards, and the node records which:
the head holds its cards whole, a virtual node may hold a fraction of one
card. A lease that holds GPUs names the card indices it was granted (ref:
ray.get_gpu_ids), so two nodes that share card 0 each grant ``cuda:0``: a
fraction of a GPU shares one index, a whole number of GPUs takes that many
free indices of its node.

Policies choose a node for each request:

* the default, hybrid: pack onto the least-utilized nodes below
  ``scheduler_spread_threshold``, else spread, breaking ties at random
  among the top ``scheduler_top_k_fraction`` (ref:
  hybrid_scheduling_policy.h:50; module-level ``random.choice``, as the
  reference);
* ``SpreadStrategy``: round-robin over the nodes that fit (ref:
  spread_scheduling_policy.h:27);
* ``NodeAffinitySchedulingStrategy`` (hard or soft) and
  ``NodeLabelSchedulingStrategy`` (hard and soft labels);
* placement groups reserve their bundles all at once or not at all (the
  reference's two-phase commit, ref: gcs_placement_group_scheduler) under
  PACK, SPREAD, STRICT_PACK (one node, nodes of an ``ici-slice`` label
  first, as the reference) and STRICT_SPREAD (a node per bundle); a
  bundle's GPU share names its cards, and a lease drawn from the bundle
  (``PlacementGroupSchedulingStrategy``) takes its cards from those. A
  group no set of nodes can hold stays pending and is retried whenever
  capacity comes back, a node added included.

A request waits while it fits some node's totals and is infeasible when it
fits none. While its task blocks in get, a lease lends its non-GPU
resources back to its node (``suspend``/``resume``).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG
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


class Node:
    """One node's resources, labels and cards (``gpu_free``: card index ->
    this node's free share of it)."""

    def __init__(self, node_id: NodeID, resources: Resources,
                 labels: Optional[Dict[str, str]] = None,
                 gpu_cards: Optional[Dict[int, float]] = None):
        self.id = node_id
        self.total: Resources = dict(resources)
        self.available: Resources = dict(resources)
        self.labels = dict(labels or {})
        self.gpu_free: Dict[int, float] = dict(gpu_cards or {})
        self.alive = True
        #: An alive node that accepts no new placements while its leases
        #: finish (the autoscaler's drain).
        self.draining = False

    def utilization(self) -> float:
        fracs = [1.0 - self.available.get(k, 0.0) / v
                 for k, v in self.total.items() if v > 0]
        return max(fracs) if fracs else 0.0

    def snapshot(self) -> dict:
        return {"NodeID": self.id, "Alive": self.alive,
                "Draining": self.draining, "Resources": dict(self.total),
                "Available": dict(self.available),
                "Labels": dict(self.labels)}

    @property
    def schedulable(self) -> bool:
        return self.alive and not self.draining

    def fits(self, request: Resources) -> bool:
        return res_fits(self.available, request) and _pick_gpus(
            self.gpu_free, request.get("GPU", 0.0)) is not None


class SchedulingStrategy:
    """Base of the strategies given through ``options(scheduling_strategy=)``
    (ref: python/ray/util/scheduling_strategies.py)."""

    name = "DEFAULT"


class DefaultStrategy(SchedulingStrategy):
    name = "DEFAULT"


class SpreadStrategy(SchedulingStrategy):
    name = "SPREAD"


class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    name = "NODE_AFFINITY"

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = NodeID(str(node_id))
        self.soft = soft


class NodeLabelSchedulingStrategy(SchedulingStrategy):
    name = "NODE_LABEL"

    def __init__(self, hard: Optional[Dict[str, str]] = None,
                 soft: Optional[Dict[str, str]] = None):
        self.hard = hard or {}
        self.soft = soft or {}


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
        #: The shares of each card the bundle reserved from its node.
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
    """Resources granted to one task or actor on ``node_id``; ``gpu_ids``
    are the card indices among them; ``bundle`` the placement-group bundle
    they come from (None: the node). While its task blocks in get, a lease
    lends its non-GPU resources back (``suspended``) and keeps its GPUs."""

    __slots__ = ("request", "gpu_ids", "released", "suspended", "bundle",
                 "node_id")

    def __init__(self, request: Resources, gpu_ids: Tuple[int, ...],
                 node_id: NodeID, bundle: Optional[_Bundle] = None):
        self.request = request
        self.gpu_ids = gpu_ids
        self.node_id = node_id
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


class ClusterScheduler:
    """Resource bookkeeping of every node, policy dispatch and the wait
    (ref: cluster_task_manager.h:42). ``acquire`` blocks until a lease is
    granted; ``try_acquire`` grants one or returns None; a release, a node
    added or a group committed or removed wakes both kinds of waiter."""

    def __init__(self) -> None:
        self._nodes: Dict[NodeID, Node] = {}
        self._pgs: Dict[PlacementGroupID, PlacementGroupState] = {}
        self._pg_pending: List[PlacementGroupState] = []
        self._lock = threading.Condition()
        self._rr_counter = 0
        #: Requests blocked for capacity (the autoscaler's demand signal).
        self._pending_demand: Dict[object, Resources] = {}
        #: Called (outside the lock) after every capacity-adding event, so
        #: the dispatcher retries blocked tasks exactly when capacity
        #: appears.
        self.on_release: Optional[Callable[[], None]] = None

    def _fire_on_release(self) -> None:
        cb = self.on_release
        if cb is not None:
            cb()

    # ------------------------------------------------------------- node admin
    def add_node(self, resources: Resources,
                 labels: Optional[Dict[str, str]] = None,
                 node_id: Optional[NodeID] = None,
                 gpu_cards: Optional[Dict[int, float]] = None) -> NodeID:
        """Add a node. ``gpu_cards`` (card index -> share) says which of
        the host's cards its ``GPU`` resource is; by default a whole number
        of GPUs is cards 0, 1, ... whole."""
        gpus = resources.get("GPU", 0.0)
        if gpu_cards is None:
            if gpus != int(gpus):
                raise ValueError(
                    f"the node's GPU count must be whole, got {gpus} (a "
                    f"fraction of a card must name the card)")
            gpu_cards = {i: 1.0 for i in range(int(gpus))}
        elif abs(sum(gpu_cards.values()) - gpus) > _EPS or any(
                not 0 < s <= 1 for s in gpu_cards.values()):
            raise ValueError(f"cards {gpu_cards} do not make {gpus} GPUs")
        node_id = node_id if node_id is not None else NodeID.from_random()
        with self._lock:
            self._nodes[node_id] = Node(node_id, resources, labels, gpu_cards)
            self._retry_pending_locked()
            self._lock.notify_all()
        self._fire_on_release()
        return node_id

    def remove_node(self, node_id: NodeID) -> bool:
        """Take a node out; its leases and bundles return to nothing."""
        with self._lock:
            node = self._nodes.pop(node_id, None)
            if node is not None:
                node.alive = False
        return node is not None

    def set_node_draining(self, node_id, draining: bool = True) -> bool:
        """Mark a node draining (no new placements; its leases run on).
        False for an unknown node. (A NodeID is its string: either keys.)"""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return False
            node.draining = bool(draining)
        return True

    def nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def get_node(self, node_id) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def cluster_resources(self) -> Resources:
        with self._lock:
            return self._sum_locked("total")

    def available_resources(self) -> Resources:
        with self._lock:
            return self._sum_locked("available")

    def _sum_locked(self, which: str) -> Resources:
        total: Resources = {}
        for n in self._nodes.values():
            res_add(total, getattr(n, which))
        return total

    def feasible(self, request: Resources,
                 strategy: Optional[SchedulingStrategy] = None) -> bool:
        """Could ``request`` ever be granted: within a live node's totals,
        or within a bundle of the strategy's live placement group."""
        with self._lock:
            return self._feasible_locked(request, strategy)

    def _feasible_locked(self, request: Resources,
                         strategy: Optional[SchedulingStrategy]) -> bool:
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = self._pgs.get(strategy.placement_group.id)
            if pg is None or pg.state == "REMOVED":
                return False
            bundles = (pg.bundles if strategy.bundle_index < 0
                       else pg.bundles[strategy.bundle_index:
                                       strategy.bundle_index + 1])
            return any(res_fits(b.resources, request) for b in bundles)
        return any(res_fits(n.total, request)
                   for n in self._nodes.values() if n.schedulable)

    # ---------------------------------------------------------------- leasing
    def acquire(self, request: Resources, timeout: Optional[float] = None,
                strategy: Optional[SchedulingStrategy] = None) -> Lease:
        """Block until ``request`` is granted. Raises InfeasibleError for a
        request that can never be."""
        deadline = None if timeout is None else time.monotonic() + timeout
        demand_key = object()
        with self._lock:
            try:
                while True:
                    lease = self._grant_locked(request, strategy)
                    if lease is not None:
                        return lease
                    if not self._feasible_locked(request, strategy):
                        raise InfeasibleError(
                            f"Resource request {request} is infeasible on "
                            f"this cluster (total={self._sum_locked('total')})")
                    self._pending_demand[demand_key] = dict(request)
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"Could not acquire {request} within timeout; "
                            f"available={self._sum_locked('available')}")
                    self._lock.wait(remaining if remaining is not None else 1.0)
            finally:
                self._pending_demand.pop(demand_key, None)

    def try_acquire(self, request: Resources,
                    strategy: Optional[SchedulingStrategy] = None
                    ) -> Optional[Lease]:
        with self._lock:
            return self._grant_locked(request, strategy)

    def release(self, lease: Lease) -> None:
        """Return a lease's resources to its bundle or node (to nothing
        when the node is gone); a second release does nothing."""
        with self._lock:
            if lease.released:
                return
            lease.released = True
            pools = self._pools_locked(lease)
            if pools is not None:
                avail, gpu_free = pools
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
            pools = self._pools_locked(lease)
            if pools is not None:
                res_add(pools[0], _lendable(lease.request))
            self._lock.notify_all()
        self._fire_on_release()

    def resume(self, lease: Lease) -> None:
        """Take back what ``suspend`` lent, waiting until it is free (at
        once when the node is gone)."""
        part = _lendable(lease.request)
        with self._lock:
            if lease.released or not lease.suspended:
                return
            while True:
                pools = self._pools_locked(lease)
                if pools is None or res_fits(pools[0], part):
                    break
                self._lock.wait(1.0)
            if pools is not None:
                res_sub(pools[0], part)
            lease.suspended = False

    def _pools_locked(self, lease: Lease):
        """Where a lease's resources return: its bundle's, or its node's;
        None when the node is gone."""
        if lease.bundle is not None:
            return lease.bundle.available, lease.bundle.gpu_free
        node = self._nodes.get(lease.node_id)
        return None if node is None else (node.available, node.gpu_free)

    def _grant_locked(self, request: Resources,
                      strategy: Optional[SchedulingStrategy]
                      ) -> Optional[Lease]:
        amount = request.get("GPU", 0.0)
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            bundle = self._find_bundle(strategy, request)
            if bundle is None:
                return None
            gpu_ids = _pick_gpus(bundle.gpu_free, amount)
            if gpu_ids is None:
                return None
            _take_gpus(bundle.gpu_free, gpu_ids, amount)
            res_sub(bundle.available, request)
            return Lease(request, gpu_ids, bundle.node_id, bundle)
        node = self._place_locked(request, strategy)
        if node is None:
            return None
        gpu_ids = _pick_gpus(node.gpu_free, amount)
        _take_gpus(node.gpu_free, gpu_ids, amount)
        res_sub(node.available, request)
        return Lease(request, gpu_ids, node.id)

    def _place_locked(self, request: Resources,
                      strategy: Optional[SchedulingStrategy]
                      ) -> Optional[Node]:
        """The node a policy picks for ``request``, or None."""
        feasible = [n for n in self._nodes.values()
                    if n.schedulable and n.fits(request)]
        if not feasible:
            return None
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            node = self._nodes.get(strategy.node_id)
            if node is not None and node in feasible:
                return node
            if not strategy.soft:
                return None
        elif isinstance(strategy, NodeLabelSchedulingStrategy):
            hard = [n for n in feasible
                    if all(n.labels.get(k) == v
                           for k, v in strategy.hard.items())]
            if not hard:
                return None
            soft = [n for n in hard
                    if all(n.labels.get(k) == v
                           for k, v in strategy.soft.items())]
            feasible = soft or hard
        elif isinstance(strategy, SpreadStrategy):
            self._rr_counter += 1
            return feasible[self._rr_counter % len(feasible)]
        # Hybrid: pack below the threshold, else least utilized; top-k
        # random tie-break.
        below = [n for n in feasible
                 if n.utilization() < GLOBAL_CONFIG.scheduler_spread_threshold]
        pool = below or feasible
        pool.sort(key=lambda n: n.utilization())
        k = max(1, int(len(pool) * GLOBAL_CONFIG.scheduler_top_k_fraction))
        return random.choice(pool[:k])

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

    # ------------------------------------------------------- autoscaler view
    def report_task_demand(self, key, request: Resources) -> None:
        """Register a request the dispatcher could not place (blocking
        ``acquire`` callers register themselves)."""
        with self._lock:
            self._pending_demand[key] = dict(request)

    def clear_task_demand(self, key) -> None:
        with self._lock:
            self._pending_demand.pop(key, None)

    def pending_demand(self) -> List[Resources]:
        """Resource shapes blocked waiting for capacity."""
        with self._lock:
            return [dict(r) for r in self._pending_demand.values()]

    def pending_pg_demand(self) -> List[List[Resources]]:
        """Bundle lists of the placement groups waiting for resources."""
        with self._lock:
            return [[dict(b.resources) for b in pg.bundles]
                    for pg in self._pg_pending]

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
        """Reserve every bundle, or none (plan on scratch copies of the
        nodes, then commit; ref: gcs_placement_group_scheduler's phases)."""
        placement = self._plan_bundles_locked(pg)
        if placement is None:
            return False
        for bundle, node, ids in placement:
            amount = bundle.resources.get("GPU", 0.0)
            _take_gpus(node.gpu_free, ids, amount)
            res_sub(node.available, bundle.resources)
            bundle.node_id = node.id
            bundle.available = dict(bundle.resources)
            bundle.gpu_reserved = {i: amount / len(ids) for i in ids}
            bundle.gpu_free = dict(bundle.gpu_reserved)
        pg.state = "CREATED"
        pg.ready_event.set()
        self._lock.notify_all()
        return True

    def _plan_bundles_locked(self, pg: PlacementGroupState):
        """[(bundle, node, card ids)] for every bundle, or None."""
        nodes = [n for n in self._nodes.values() if n.schedulable]
        if not nodes:
            return None
        scratch: Dict[NodeID, Tuple[Resources, Dict[int, float]]] = {}
        placement: list = []

        def reset() -> None:
            placement.clear()
            for n in nodes:
                scratch[n.id] = (dict(n.available), dict(n.gpu_free))

        def fit_on(node: Node, bundle: _Bundle) -> bool:
            avail, gpu_free = scratch[node.id]
            amount = bundle.resources.get("GPU", 0.0)
            ids = _pick_gpus(gpu_free, amount) \
                if res_fits(avail, bundle.resources) else None
            if ids is None:
                return False
            _take_gpus(gpu_free, ids, amount)
            res_sub(avail, bundle.resources)
            placement.append((bundle, node, ids))
            return True

        reset()
        strategy = pg.strategy
        if strategy == "STRICT_PACK":
            ordered = sorted(nodes, key=lambda n: (
                n.labels.get("ici-slice", ""), -sum(n.available.values())))
            for node in ordered:
                reset()
                if all(fit_on(node, b) for b in pg.bundles):
                    return placement
            return None
        if strategy == "STRICT_SPREAD":
            if len(nodes) < len(pg.bundles):
                return None
            used = set()
            for bundle in pg.bundles:
                cands = sorted((n for n in nodes if n.id not in used),
                               key=lambda n: n.utilization())
                for node in cands:
                    if fit_on(node, bundle):
                        used.add(node.id)
                        break
                else:
                    return None
            return placement
        if strategy == "SPREAD":
            i = 0
            for bundle in pg.bundles:
                for attempt in range(len(nodes)):
                    if fit_on(nodes[(i + attempt) % len(nodes)], bundle):
                        i += attempt + 1
                        break
                else:
                    return None
            return placement
        # PACK: fill nodes in ici-slice order, least utilized first.
        ordered = sorted(nodes, key=lambda n: (n.labels.get("ici-slice", ""),
                                               n.utilization()))
        for bundle in pg.bundles:
            if not any(fit_on(node, bundle) for node in ordered):
                return None
        return placement

    def _retry_pending_locked(self) -> None:
        still = []
        for pg in self._pg_pending:
            if pg.state == "PENDING" and not self._try_commit_locked(pg):
                still.append(pg)
        self._pg_pending = still

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        """Give a group's bundles back to their nodes that are still there
        (leases still drawn from them return to nothing once released)."""
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            if pg is None:
                return
            if pg.state == "CREATED":
                for b in pg.bundles:
                    node = self._nodes.get(b.node_id)
                    if node is None:
                        continue
                    res_add(node.available, b.resources)
                    for i, share in b.gpu_reserved.items():
                        node.gpu_free[i] += share
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
