"""Virtual nodes: the port's ``ClusterScheduler``, ``cluster_utils.Cluster``
and ``autoscaler/elastic.py`` against the reference's.

The reference's multi-node cases (the ``ray_start_cluster`` cases of
tests/test_scheduling.py, tests/test_chaos.py's blocked task that
dispatches when a node joins, and tests/test_checkpoint_subsystem.py's peer
replica holder) run on both packages, one after the other, each on a
``Cluster`` whose head has 2 CPUs; what each observed is compared, nodes by
the order they were added (never by ID). The schedulers are then driven
through the same seeded sequence of nodes, leases under every strategy,
placement groups and node removals, with module-level ``random`` seeded the
same way before each run (both break ties with ``random.choice``): the
chosen nodes and every node's available resources must be equal. Equal
means equal: integers, and float sums of the same terms in the same order.
One difference is kept on purpose: the port retries a pending placement
group whenever capacity comes back, the reference only when a node joins,
so the reference's driver runs its own retry after a release or a group's
removal.

The port's own cases follow: virtual nodes that share card 0 each grant
``cuda:0``, a card the host lacks is refused, a removed node's tasks and
actors fail over as the reference's node loss does, and the head's labels.
"""

import importlib
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused

T = 30  # seconds any one get or wait may take


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _strategies(pkg):
    return _mod(pkg, "util.scheduling_strategies")


def _submitted_nodes(pkg, order):
    """Node index (order added) of every task dispatch so far."""
    events = _mod(pkg, "_private.runtime").get_runtime().list_task_events()
    return [order.index(e["node_id"]) for e in events
            if e["state"] == "SUBMITTED_TO_WORKER" and "node_id" in e]


def on_cluster(pkg, case):
    """Run ``case(pkg, cluster, order)`` on a fresh Cluster (head: 2 CPUs);
    ``order`` lists node ids as strings in the order they were added."""
    for other in (ray_tpu, ray_tpu_torch):
        importlib.import_module(other.__name__ + ".serve").shutdown()
        other.shutdown()
    cluster = _mod(pkg, "cluster_utils").Cluster(
        initialize_head=True, head_node_args={"num_cpus": 2})
    order = [str(cluster.head_node_id)]
    real_add = cluster.add_node

    def add_node(*args, **kwargs):
        node_id = real_add(*args, **kwargs)
        order.append(str(node_id))
        return node_id

    cluster.add_node = add_node
    try:
        return bounded(lambda: case(pkg, cluster, order), 120)
    finally:
        cluster.shutdown()


def both_on_cluster(case):
    with gc_paused():
        ref = on_cluster(ray_tpu, case)
    return ref, on_cluster(ray_tpu_torch, case)


# ------------------------------------------- tests/test_scheduling.py cases
def spread_across_nodes(pkg, cluster, order):
    for _ in range(3):
        cluster.add_node(num_cpus=2)

    @pkg.remote(num_cpus=1)
    def where():
        return True

    spread = _strategies(pkg).SpreadStrategy
    refs = [where.options(scheduling_strategy=spread()).remote()
            for _ in range(8)]
    return [pkg.get(refs, timeout=T),
            len(set(_submitted_nodes(pkg, order))) > 1]


def node_affinity(pkg, cluster, order):
    target = cluster.add_node(num_cpus=2, resources={"special": 1})

    @pkg.remote(num_cpus=1)
    def f():
        return 1

    ref = f.options(scheduling_strategy=_strategies(
        pkg).NodeAffinitySchedulingStrategy(node_id=str(target))).remote()
    return [pkg.get(ref, timeout=T), _submitted_nodes(pkg, order)]


def node_labels(pkg, cluster, order):
    cluster.add_node(num_cpus=2, labels={"zone": "us-central2-b"})

    @pkg.remote(num_cpus=1)
    def f():
        return "labeled"

    ref = f.options(scheduling_strategy=_strategies(
        pkg).NodeLabelSchedulingStrategy(hard={"zone": "us-central2-b"})
    ).remote()
    return [pkg.get(ref, timeout=T), _submitted_nodes(pkg, order)]


def custom_resources(pkg, cluster, order):
    # The reference's case asks for TPUs; a custom resource of that name
    # is the same request on both packages.
    cluster.add_node(num_cpus=1, resources={"TPU": 4})

    @pkg.remote(resources={"TPU": 2})
    def tpu_task():
        return "on tpu node"

    return [pkg.get(tpu_task.remote(), timeout=T),
            _submitted_nodes(pkg, order)]


def _pg(pkg):
    return _mod(pkg, "util.placement_group")


def _bundle_nodes(pg, order):
    return [order.index(n) for n in pg.bundle_node_ids()]


def pg_pack(pkg, cluster, order):
    cluster.add_node(num_cpus=4)
    pg = _pg(pkg).placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    return [pg.wait(5), _bundle_nodes(pg, order)]


def pg_strict_spread(pkg, cluster, order):
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    pg = _pg(pkg).placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    return [pg.wait(5), sorted(_bundle_nodes(pg, order))]


def pg_strict_pack_ici_slice(pkg, cluster, order):
    cluster.add_node(num_cpus=1, labels={"ici-slice": "slice-a"})
    cluster.add_node(num_cpus=8, labels={"ici-slice": "slice-b"})
    pg = _pg(pkg).placement_group([{"CPU": 2}] * 3, strategy="STRICT_PACK")
    return [pg.wait(5), _bundle_nodes(pg, order)]


def pg_task_scheduling(pkg, cluster, order):
    cluster.add_node(num_cpus=4)
    pg = _pg(pkg).placement_group([{"CPU": 2}], strategy="PACK")
    ready = pg.wait(5)

    @pkg.remote(num_cpus=1)
    def inside():
        return "in bundle"

    ref = inside.options(scheduling_strategy=_strategies(
        pkg).PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
    return [ready, pkg.get(ref, timeout=T), _bundle_nodes(pg, order),
            _submitted_nodes(pkg, order)]


def pg_pending_until_node_added(pkg, cluster, order):
    pg = _pg(pkg).placement_group([{"CPU": 16}], strategy="PACK")
    before = pg.wait(0.2)
    cluster.add_node(num_cpus=16)
    return [before, pg.wait(5), _bundle_nodes(pg, order)]


def pg_remove_releases_resources(pkg, cluster, order):
    cluster.add_node(num_cpus=4)
    mod = _pg(pkg)
    pg = mod.placement_group([{"CPU": 4}], strategy="PACK")
    ready = pg.wait(5)
    avail_before = pkg.available_resources().get("CPU", 0)
    mod.remove_placement_group(pg)
    time.sleep(0.1)
    return [ready, avail_before, pkg.available_resources().get("CPU", 0),
            str(pg.id) in mod.placement_group_table()]


def actor_in_pg(pkg, cluster, order):
    cluster.add_node(num_cpus=4)
    pg = _pg(pkg).placement_group([{"CPU": 2}], strategy="PACK")
    ready = pg.wait(5)

    @pkg.remote(num_cpus=1)
    class Worker:
        def ping(self):
            return "pong"

    a = Worker.options(scheduling_strategy=_strategies(
        pkg).PlacementGroupSchedulingStrategy(placement_group=pg)).remote()
    return [ready, pkg.get(a.ping.remote(), timeout=T),
            _bundle_nodes(pg, order)]


# ------------------------------------------------ tests/test_chaos.py:93
def blocked_task_dispatches_when_node_added(pkg, cluster, order):
    cluster.add_node(num_cpus=2, resources={"special": 1})
    gate = threading.Event()

    @pkg.remote(resources={"special": 1})
    def hold():
        gate.wait(30)
        return "held"

    @pkg.remote(resources={"special": 1})
    def probe():
        return "ok"

    holder = hold.remote()  # occupies the only "special" slot
    time.sleep(0.3)
    ref = probe.remote()  # feasible but no capacity: blocked
    ready, _ = pkg.wait([ref], num_returns=1, timeout=0.5)
    blocked = not ready
    scheduler = _mod(pkg, "_private.runtime").get_runtime().scheduler
    deadline = time.monotonic() + T
    while not scheduler.pending_demand() and time.monotonic() < deadline:
        time.sleep(0.01)
    demand = scheduler.pending_demand()  # the autoscaler's signal
    cluster.add_node(num_cpus=2, resources={"special": 1})
    out = [blocked, demand, pkg.get(ref, timeout=20),
           scheduler.pending_demand()]
    gate.set()
    return out + [pkg.get(holder, timeout=20),
                  sorted(_submitted_nodes(pkg, order))]


# ------------------------------ tests/test_checkpoint_subsystem.py:328
def peer_holder_placement_and_fetch(pkg, cluster, order):
    start_peer_holder = _mod(pkg, "checkpoint.replica").start_peer_holder
    single = start_peer_holder()
    node = cluster.add_node(num_cpus=2)
    holder = start_peer_holder()
    runtime = _mod(pkg, "_private.runtime").get_runtime()
    state = runtime.get_actor_state(holder._ray_actor_id)
    payload = {"doc": {"leaves": []}, "skeleton": None, "kind": "json",
               "arrays": {"leaf_0": np.ones(4, np.float32)},
               "shard_id": 0, "step": 3}
    ref = pkg.put(payload)
    pkg.get(holder.hold.remote(3, 0, {"ref": ref}), timeout=T)
    held = pkg.get(holder.held.remote(), timeout=T)
    fetched = pkg.get(holder.fetch.remote(3), timeout=T)
    pkg.get(holder.trim.remote([]), timeout=T)
    return [single is None, order.index(str(state.node_id)),
            str(node) == str(state.node_id), held,
            fetched[0]["arrays"]["leaf_0"].tolist(),
            pkg.get(holder.held.remote(), timeout=T)]


CLUSTER_CASES = [
    spread_across_nodes, node_affinity, node_labels, custom_resources,
    pg_pack, pg_strict_spread, pg_strict_pack_ici_slice, pg_task_scheduling,
    pg_pending_until_node_added, pg_remove_releases_resources, actor_in_pg,
    blocked_task_dispatches_when_node_added, peer_holder_placement_and_fetch,
]


@pytest.mark.parametrize("case", CLUSTER_CASES, ids=lambda f: f.__name__)
def test_cluster_case_matches_reference(case):
    ref, port = both_on_cluster(case)
    assert port == ref


# ------------------------------------------ the schedulers, op by op
class _Driver:
    """One package's ClusterScheduler behind one interface."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.sched_mod = _mod(pkg, "_private.scheduling")
        self.ids = _mod(pkg, "_private.ids")
        self.sched = self.sched_mod.ClusterScheduler()
        self.order = []  # node ids, in the order added

    def add_node(self, resources, labels):
        self.order.append(self.sched.add_node(resources, labels))

    def try_acquire(self, request, strategy):
        got = self.sched.try_acquire(request, strategy)
        if got is None:
            return None, None
        if self.pkg is ray_tpu:
            node_id, ref_release = got

            def release():
                ref_release()
                self.retry_pending()
        else:
            node_id = got.node_id
            release = lambda lease=got: self.sched.release(lease)  # noqa: E731
        return self.order.index(node_id), release

    def strategy(self, kind, arg=None, soft=False):
        m = self.sched_mod
        if kind == "default":
            return None
        if kind == "spread":
            return m.SpreadStrategy()
        if kind == "affinity":
            return m.NodeAffinitySchedulingStrategy(str(self.order[arg]),
                                                    soft=soft)
        if kind == "label":
            return m.NodeLabelSchedulingStrategy(hard={"zone": arg})
        return m.PlacementGroupSchedulingStrategy(SimpleNamespace(id=arg))

    def retry_pending(self):
        """The port retries a pending group whenever capacity comes back
        (a release, a group removed, a node added); the reference only when
        a node is added. Its own retry is run here after the other two, so
        that the rest of the decisions can be held equal."""
        if self.pkg is ray_tpu:
            with self.sched._lock:
                self.sched._retry_pending_pgs_locked()

    def remove_pg(self, pg_id):
        self.sched.remove_placement_group(pg_id)
        self.retry_pending()

    def create_pg(self, bundles, strategy):
        pg_id = self.ids.PlacementGroupID.from_random()
        state = self.sched.create_placement_group(pg_id, bundles, strategy)
        return pg_id, state

    def pg_nodes(self, state):
        return [None if b.node_id is None else self.order.index(b.node_id)
                for b in state.bundles]

    def available(self):
        """Each node's available resources, in the order added (removed
        nodes as None)."""
        live = {n.id: n for n in self.sched.nodes()}
        return [dict(live[i].available) if i in live else None
                for i in self.order]


def _drive(pkg, seed, steps=60):
    """The observations of one seeded sequence of operations."""
    rng = np.random.default_rng(seed)
    random.seed(seed)
    d = _Driver(pkg)
    zones = ("a", "b")
    for i in range(4):
        d.add_node({"CPU": float(rng.integers(1, 5)), "accel": 2.0},
                   {"zone": zones[i % 2]})
    held, pgs, log = [], [], []
    for _ in range(steps):
        op = int(rng.integers(0, 10))
        if op <= 4:  # a lease under one of the strategies
            kind = ("default", "spread", "affinity", "label", "pg")[op]
            arg = soft = None
            if kind == "affinity":
                arg, soft = int(rng.integers(0, len(d.order))), \
                    bool(rng.integers(0, 2))
            elif kind == "label":
                arg = zones[int(rng.integers(0, 2))]
            elif kind == "pg":
                live = [p for p in pgs if p[1].state == "CREATED"]
                if not live:
                    continue
                arg = live[int(rng.integers(0, len(live)))][0]
            request = {"CPU": 1.0} if rng.integers(0, 3) else {"accel": 1.0}
            node, release = d.try_acquire(request, d.strategy(kind, arg, soft))
            log.append(("lease", kind, node))
            if release is not None:
                held.append(release)
        elif op == 5 and held:
            held.pop(int(rng.integers(0, len(held))))()
            log.append(("release",))
        elif op == 6:
            strategy = ("PACK", "SPREAD", "STRICT_PACK",
                        "STRICT_SPREAD")[int(rng.integers(0, 4))]
            n = int(rng.integers(1, 4))
            pgs.append(d.create_pg([{"CPU": 1.0}] * n, strategy))
            log.append(("pg", strategy, pgs[-1][1].state,
                        d.pg_nodes(pgs[-1][1])))
        elif op == 7 and pgs:
            pg_id, _ = pgs.pop(int(rng.integers(0, len(pgs))))
            d.remove_pg(pg_id)
            log.append(("remove_pg", [d.pg_nodes(s) for _, s in pgs]))
        elif op == 8:
            if rng.integers(0, 2) and len(d.sched.nodes()) > 1:
                live = [i for i, nid in enumerate(d.order)
                        if d.sched.get_node(nid) is not None]
                victim = live[int(rng.integers(0, len(live)))]
                d.sched.remove_node(d.order[victim])
                log.append(("remove_node", victim))
            else:
                d.add_node({"CPU": float(rng.integers(1, 5)), "accel": 2.0},
                           {"zone": zones[int(rng.integers(0, 2))]})
                log.append(("add_node", [s.state for _, s in pgs]))
        elif op == 9:  # drain a node, or end a drain
            i = int(rng.integers(0, len(d.order)))
            node = d.sched.get_node(d.order[i])
            drained = d.sched.set_node_draining(
                d.order[i], not (node is not None and node.draining))
            log.append(("drain", i, drained))
        log.append(("available", d.available()))
    return log


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_decisions_match_reference(seed):
    """The same seeded operations give the same node for every lease and
    bundle and the same available resources on every node after each."""
    assert _drive(ray_tpu_torch, seed) == _drive(ray_tpu, seed)


# ------------------------------------------------- autoscaler/elastic.py
def capacity(pkg, cluster, order):
    elastic = _mod(pkg, "autoscaler.elastic")
    cluster.add_node(num_cpus=1)
    cluster.add_node(num_cpus=3, resources={"accel": 2})
    gone = cluster.add_node(num_cpus=2, resources={"accel": 1})
    bundles = [{"CPU": 1}, {"CPU": 2}, {"accel": 1}, {"CPU": 1, "accel": 1},
               {"CPU": 0.5}, {"missing": 1}]
    out = [[elastic.worker_capacity(b) for b in bundles],
           [elastic.worker_capacity(b, exclude_nodes={str(gone)})
            for b in bundles],
           elastic.capacity_available({"CPU": 1}, 8),
           elastic.capacity_available({"CPU": 1}, 9),
           order.index(elastic.pick_preemptible_node()),
           order.index(elastic.pick_preemptible_node(exclude_head=False))]

    @pkg.remote(num_cpus=0)
    class Pinned:
        def ping(self):
            return "pong"

    affinity = _strategies(pkg).NodeAffinitySchedulingStrategy
    actors = [Pinned.options(scheduling_strategy=affinity(str(gone))).remote()
              for _ in range(2)]
    pkg.get([a.ping.remote() for a in actors], timeout=T)
    on_node = len(elastic.actors_on_node(str(gone)))
    preempted = elastic.simulate_preemption(str(gone))
    dead = []
    for a in actors:
        try:
            pkg.get(a.ping.remote(), timeout=T)
            dead.append(False)
        except Exception as e:  # noqa: BLE001 — the observation
            dead.append(type(e).__name__)
    return out + [on_node, order.index(preempted), dead,
                  [elastic.worker_capacity(b) for b in bundles],
                  sorted(order.index(str(n["NodeID"])) for n in pkg.nodes())]


def test_worker_capacity_matches_reference():
    """worker_capacity, capacity_available, pick_preemptible_node and
    simulate_preemption on the same cluster (integers, equal)."""
    ref, port = both_on_cluster(capacity)
    assert port == ref


# ------------------------------------------------------------ the port's
@pytest.fixture
def one_card(monkeypatch):
    """A head without a GPU on a host with one (faked) card."""
    from ray_tpu_torch._private import device
    from ray_tpu_torch.cluster_utils import Cluster

    monkeypatch.setattr(device, "gpu_count", lambda: 1)
    fresh_init(ray_tpu_torch, num_cpus=2, num_gpus=0)
    yield Cluster()
    ray_tpu_torch.shutdown()


def test_nodes_sharing_card_zero_each_grant_it(one_card):
    """Two virtual nodes with half of card 0 each: an actor placed on each
    (by node affinity) is granted card 0, and the cluster holds one GPU."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    nodes = [one_card.add_node(num_cpus=1, num_gpus=0.5) for _ in range(2)]

    @ray_tpu_torch.remote(num_gpus=0.5)
    class Rank:
        def card(self):
            return ray_tpu_torch.get_gpu_ids()

    ranks = [Rank.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        str(n))).remote() for n in nodes]
    assert ray_tpu_torch.get([r.card.remote() for r in ranks],
                             timeout=T) == [[0], [0]]
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    assert ray_tpu_torch.available_resources()["GPU"] == 0.0
    runtime = ray_tpu_torch._private.runtime.get_runtime()
    assert [str(runtime.get_actor_state(r._ray_actor_id).node_id)
            for r in ranks] == [str(n) for n in nodes]


def test_add_node_refuses_a_card_the_host_lacks(one_card):
    with pytest.raises(ValueError, match="host has 1"):
        one_card.add_node(num_gpus=0.5, gpu_index=1)
    with pytest.raises(ValueError, match="host has 1"):
        one_card.add_node(num_gpus=2)
    with pytest.raises(ValueError, match="whole"):
        one_card.add_node(num_gpus=1.5)
    assert len(ray_tpu_torch.nodes()) == 1


def test_real_cluster_raises():
    from ray_tpu_torch.cluster_utils import Cluster

    with pytest.raises(NotImplementedError, match="13.8b"):
        Cluster(real=True)


def test_nodes_list_resources_and_labels():
    """nodes() lists every node with Alive, Resources, Available and
    Labels; init(labels=) goes over the detected labels; a removed node
    leaves the list."""
    from ray_tpu_torch.cluster_utils import Cluster

    fresh_init(ray_tpu_torch, num_cpus=2, labels={"zone": "z1"})
    try:
        cluster = Cluster()
        node = cluster.add_node(num_cpus=3, resources={"accel": 1},
                                labels={"zone": "z2"})
        rows = {str(n["NodeID"]): n for n in ray_tpu_torch.nodes()}
        head = rows[str(ray_tpu_torch._private.runtime.get_runtime()
                        .head_node_id)]
        assert head["Alive"] and head["Labels"] == {"zone": "z1"}
        assert head["Resources"]["CPU"] == 2.0
        row = rows[str(node)]
        assert row["Resources"] == {"CPU": 3.0, "accel": 1.0}
        assert row["Available"] == row["Resources"]
        assert row["Labels"] == {"zone": "z2"}
        assert ray_tpu_torch.cluster_resources()["CPU"] == 5.0
        cluster.remove_node(node)
        assert [str(n["NodeID"]) for n in ray_tpu_torch.nodes()] == \
            [str(head["NodeID"])]
    finally:
        ray_tpu_torch.shutdown()


def test_removed_node_fails_over_its_tasks_and_actors():
    """remove_node takes a node out as its loss would: a task running there
    is retried on another node (its first thread's result is dropped), an
    actor with a restart left comes back on another node, and one without
    dies with ActorDiedError."""
    from ray_tpu_torch._private.runtime import current_task_context
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    fresh_init(ray_tpu_torch, num_cpus=0)
    try:
        cluster = Cluster()
        doomed = cluster.add_node(num_cpus=2)
        spare = cluster.add_node(num_cpus=2)
        runtime = ray_tpu_torch._private.runtime.get_runtime()
        on_doomed = NodeAffinitySchedulingStrategy(str(doomed), soft=True)
        gate, started, runs = threading.Event(), threading.Event(), []

        @ray_tpu_torch.remote(num_cpus=1, max_retries=1)
        def slow():
            node = str(current_task_context().lease.node_id)
            runs.append(node)
            started.set()
            if node == str(doomed):
                gate.wait(30)
            return node

        @ray_tpu_torch.remote
        class Pinned:
            def ping(self):
                return "pong"

        ref = slow.options(scheduling_strategy=on_doomed).remote()
        assert started.wait(T)
        keep = Pinned.options(max_restarts=1,
                              scheduling_strategy=on_doomed).remote()
        lose = Pinned.options(scheduling_strategy=on_doomed).remote()
        assert ray_tpu_torch.get([keep.ping.remote(), lose.ping.remote()],
                                 timeout=T) == ["pong"] * 2
        states = [runtime.get_actor_state(a._ray_actor_id)
                  for a in (keep, lose)]
        assert [str(s.node_id) for s in states] == [str(doomed)] * 2
        cluster.remove_node(doomed)
        assert ray_tpu_torch.get(ref, timeout=T) == str(spare)
        gate.set()
        assert runs == [str(doomed), str(spare)]
        assert ray_tpu_torch.get(keep.ping.remote(), timeout=T) == "pong"
        assert str(states[0].node_id) != str(doomed)  # the head or spare
        assert states[0].num_restarts == 1 and states[1].state == "DEAD"
        with pytest.raises(ActorDiedError):
            ray_tpu_torch.get(lose.ping.remote(), timeout=T)
    finally:
        ray_tpu_torch.shutdown()
