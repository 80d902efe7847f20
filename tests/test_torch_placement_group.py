"""The port's placement groups (ray_tpu_torch.util.placement_group) against
the reference's (ray_tpu.util.placement_group) on the cases of
tests/test_scheduling.py that hold on one node.

Each case runs on both packages, one after the other, on a runtime of one
node with 4 CPUs (the reference's cases add a node to a cluster; here the
head node is the one node). The cases that need a second node run on
virtual nodes in tests/test_torch_cluster.py; STRICT_SPREAD's other half,
a group no set of nodes can hold staying pending, holds here. The port's own cases
follow: bundles that name their cards, all-or-nothing reservation, and a
pending group that commits once capacity comes back.
"""

import importlib
import time

import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import both

T = 30


def _pg(pkg):
    return importlib.import_module(pkg.__name__ + ".util.placement_group")


def _strategy(pkg):
    return importlib.import_module(
        pkg.__name__ + ".util.scheduling_strategies"
    ).PlacementGroupSchedulingStrategy


def pg_pack(pkg):
    pg = _pg(pkg).placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ready = pg.wait(5)
    nodes = pg.bundle_node_ids()
    return [ready, nodes[0] == nodes[1], nodes[0] is not None]


def pg_task_scheduling(pkg):
    pg = _pg(pkg).placement_group([{"CPU": 2}], strategy="PACK")
    ready = pg.wait(5)

    @pkg.remote(num_cpus=1)
    def inside():
        return "in bundle"

    ref = inside.options(scheduling_strategy=_strategy(pkg)(
        placement_group=pg, placement_group_bundle_index=0)).remote()
    return [ready, pkg.get(ref, timeout=T)]


def pg_remove_releases_resources(pkg):
    mod = _pg(pkg)
    pg = mod.placement_group([{"CPU": 4}], strategy="PACK")
    ready = pg.wait(5)
    avail_before = pkg.available_resources().get("CPU", 0)
    mod.remove_placement_group(pg)
    time.sleep(0.1)
    return [ready, avail_before, pkg.available_resources().get("CPU", 0),
            str(pg.id) in mod.placement_group_table()]


def actor_in_pg(pkg):
    pg = _pg(pkg).placement_group([{"CPU": 2}], strategy="PACK")
    ready = pg.wait(5)

    @pkg.remote(num_cpus=1)
    class Worker:
        def ping(self):
            return "pong"

    a = Worker.options(scheduling_strategy=_strategy(pkg)(
        placement_group=pg)).remote()
    return [ready, pkg.get(a.ping.remote(), timeout=T)]


def pg_strict_spread_stays_pending(pkg):
    mod = _pg(pkg)
    pg = mod.placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    ready = pg.wait(0.3)
    row = mod.placement_group_table()[str(pg.id)]
    return [ready, row["state"], row["strategy"],
            pkg.available_resources().get("CPU", 0)]


def pg_table_rows(pkg):
    mod = _pg(pkg)
    pg = mod.placement_group([{"CPU": 1}, {"CPU": 2}], strategy="SPREAD",
                             name="rows")
    pg.wait(5)
    row = mod.placement_group_table()[str(pg.id)]
    return [row, pg.bundle_specs, pg.bundle_count,
            pkg.available_resources().get("CPU", 0)]


def pg_bad_arguments(pkg):
    mod = _pg(pkg)
    out = []
    for bundles, strategy in (([{"CPU": 1}], "NOPE"), ([], "PACK"),
                              ([{}], "PACK")):
        try:
            mod.placement_group(bundles, strategy=strategy)
            out.append(None)
        except ValueError:
            out.append("ValueError")
    return out


@pytest.mark.parametrize("case", [
    pg_pack, pg_task_scheduling, pg_remove_releases_resources, actor_in_pg,
    pg_strict_spread_stays_pending, pg_table_rows, pg_bad_arguments,
], ids=lambda f: f.__name__)
def test_matches_reference(case):
    ref, port = both(case)
    assert ref == port


# ---------------------------------------------------------------- the port's
@pytest.fixture
def two_cards(monkeypatch):
    """A runtime of one node with two faked cards."""
    from ray_tpu_torch._private import device

    monkeypatch.setattr(device, "gpu_count", lambda: 2)
    fresh_init(ray_tpu_torch, num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


def _gpu_ids_in(pg, index, num_gpus):
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    @ray_tpu_torch.remote(num_gpus=num_gpus, num_cpus=0)
    def ids():
        return ray_tpu_torch.get_gpu_ids()

    return ray_tpu_torch.get(ids.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=index)).remote(), timeout=T)


def test_bundles_name_their_cards(two_cards):
    from ray_tpu_torch.util.placement_group import placement_group

    whole = placement_group([{"GPU": 1}, {"GPU": 1}])
    assert whole.wait(5)
    assert [_gpu_ids_in(whole, i, 1) for i in (0, 1)] == [[0], [1]]
    assert ray_tpu_torch.available_resources()["GPU"] == 0


def test_shared_card_bundles_lease_that_card(two_cards):
    """Two half-card bundles share card 0; a lease from either, or from the
    first bundle with room (-1), names card 0."""
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )

    pg = placement_group([{"GPU": 0.5}, {"GPU": 0.5}])
    assert pg.wait(5)
    assert [_gpu_ids_in(pg, i, 0.5) for i in (0, 1, -1)] == [[0]] * 3
    assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    remove_placement_group(pg)
    assert ray_tpu_torch.available_resources()["GPU"] == 2.0


def test_reservation_is_all_or_nothing(two_cards):
    """Groups that do not fit reserve nothing and stay pending: three
    whole-card bundles on two cards never fit, while a group of two commits
    as soon as the group holding a card is removed."""
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        placement_group_table,
        remove_placement_group,
    )

    holder = placement_group([{"GPU": 1}])
    assert holder.wait(5)
    too_big = placement_group([{"GPU": 1}] * 3)
    waiting = placement_group([{"GPU": 1}] * 2)
    assert not too_big.wait(0.2) and not waiting.wait(0.2)
    assert ray_tpu_torch.available_resources()["GPU"] == 1.0
    remove_placement_group(holder)
    assert waiting.wait(5), "a pending group must commit once cards return"
    assert not too_big.wait(0.2)
    assert placement_group_table()[str(too_big.id)]["state"] == "PENDING"
    assert ray_tpu_torch.available_resources()["GPU"] == 0.0
    remove_placement_group(too_big)
    remove_placement_group(waiting)
    assert ray_tpu_torch.available_resources()["GPU"] == 2.0


def test_request_beyond_its_bundle_is_infeasible():
    from ray_tpu_torch._private.scheduling import InfeasibleError
    from ray_tpu_torch.util.placement_group import placement_group
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        pg = placement_group([{"CPU": 2}])
        assert pg.wait(5)

        @ray_tpu_torch.remote(num_cpus=3)
        def big():
            return 1

        ref = big.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0)).remote()
        with pytest.raises(ray_tpu_torch.exceptions.TaskError,
                           match="placement group") as info:
            ray_tpu_torch.get(ref, timeout=T)
        assert isinstance(info.value.cause, InfeasibleError)
    finally:
        ray_tpu_torch.shutdown()


def test_a_full_bundle_queues_its_next_lease():
    """A task waits for its bundle, not for the node: with the node free but
    the bundle busy, the second task starts only after the first ends."""
    import threading

    from ray_tpu_torch.util.placement_group import placement_group
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        pg = placement_group([{"CPU": 1}])
        assert pg.wait(5)
        gate = threading.Event()
        order = []

        @ray_tpu_torch.remote(num_cpus=1)
        def hold(tag):
            order.append(tag)
            if tag == "first":
                gate.wait(10)
            return tag

        strat = PlacementGroupSchedulingStrategy(pg, 0)
        a = hold.options(scheduling_strategy=strat).remote("first")
        time.sleep(0.2)
        b = hold.options(scheduling_strategy=strat).remote("second")
        time.sleep(0.3)
        assert order == ["first"], "the bundle's one CPU is taken"
        gate.set()
        assert ray_tpu_torch.get([a, b], timeout=T) == ["first", "second"]
    finally:
        ray_tpu_torch.shutdown()


def test_blocked_leases_queue_by_bundle_not_by_strategy_object():
    """Specs blocked on one bundle share one FIFO bucket however many
    strategy objects name it; another bundle, another group or the node is
    another bucket."""
    from types import SimpleNamespace

    from ray_tpu_torch._private.runtime import Runtime
    from ray_tpu_torch.util.placement_group import placement_group
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        pg, other = placement_group([{"CPU": 1}] * 2), placement_group(
            [{"CPU": 1}])
        assert pg.wait(5) and other.wait(5)

        def key(strategy):
            return Runtime._placement_shape(SimpleNamespace(
                resources={"CPU": 1.0}, strategy=strategy))

        same = {key(PlacementGroupSchedulingStrategy(pg, 0))
                for _ in range(3)}
        assert len(same) == 1
        keys = [key(PlacementGroupSchedulingStrategy(pg, 0)),
                key(PlacementGroupSchedulingStrategy(pg, 1)),
                key(PlacementGroupSchedulingStrategy(pg, -1)),
                key(PlacementGroupSchedulingStrategy(other, 0)), key(None)]
        assert len(set(keys)) == len(keys)
    finally:
        ray_tpu_torch.shutdown()
