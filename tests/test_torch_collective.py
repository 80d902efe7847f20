"""The port's collective groups (ray_tpu_torch.collective) against the
reference's (ray_tpu.collective) on the cases of tests/test_collective.py.

Each case runs on both packages, one after the other, with the same numpy
inputs: the reference's group runs its ops on the 8 CPU devices of
tests/conftest.py, the port's thread group with torch on the host. Integer
results must be equal, float results within 1e-6. Left out:
``test_collectives_ride_the_mesh``, which inspects JAX's lowered mesh
programs. The port's own cases follow: ops across dtypes, the backend
names, a destroyed or re-formed group refusing the ranks it had, the
process tier over gloo in two worker processes, and the stream order of
thread ranks on the card (tests/test_torch_cuda.py).
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.collective  # noqa: F401 — pkg.collective below
import ray_tpu_torch
import ray_tpu_torch.collective  # noqa: F401
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both, raises

WORLD = 4
T = 60  # seconds any one get may wait


def _col(pkg):
    return pkg.collective


def _ranks(pkg, world=WORLD, group="g"):
    col = _col(pkg)

    class Rank:
        def __init__(self, rank, world, group="g"):
            self.rank = rank
            self.group = group
            col.init_collective_group(world, rank, group_name=group)

        def allreduce(self, value):
            return np.asarray(col.allreduce(np.asarray(value, np.float32),
                                            group_name=self.group))

        def allgather(self, value):
            return np.asarray(col.allgather(np.asarray(value, np.float32),
                                            group_name=self.group))

        def reducescatter(self, mat):
            return np.asarray(col.reducescatter(np.asarray(mat, np.float32),
                                                group_name=self.group))

        def broadcast(self, value, src):
            return np.asarray(col.broadcast(np.asarray(value, np.float32),
                                            src_rank=src,
                                            group_name=self.group))

        def sendrecv_ring(self, value):
            group = col.get_collective_group(self.group)
            perm = [(i, (i + 1) % world) for i in range(world)]
            return np.asarray(group.send_recv(
                self.rank, np.asarray(value, np.float32), perm))

        def barrier(self):
            col.barrier(group_name=self.group)
            return True

    actors = [pkg.remote(Rank).options(max_concurrency=2).remote(i, world,
                                                                   group)
              for i in range(world)]
    pkg.get([a.barrier.remote() for a in actors], timeout=T)
    return actors


def allreduce_sum(pkg):
    ranks = _ranks(pkg)
    out = pkg.get([a.allreduce.remote([float(i + 1)] * 8)
                   for i, a in enumerate(ranks)], timeout=T)
    _col(pkg).destroy_collective_group("g")
    return out


def allreduce_repeated_rounds(pkg):
    ranks = _ranks(pkg)
    out = [pkg.get([a.allreduce.remote([float(r)]) for a in ranks],
                   timeout=T) for r in range(3)]
    _col(pkg).destroy_collective_group("g")
    return out


def allgather(pkg):
    ranks = _ranks(pkg)
    out = pkg.get([a.allgather.remote([float(i)] * 4)
                   for i, a in enumerate(ranks)], timeout=T)
    _col(pkg).destroy_collective_group("g")
    return out


def reducescatter(pkg):
    ranks = _ranks(pkg)
    mat = np.arange(WORLD * 3, dtype=np.float32).reshape(WORLD, 3)
    out = pkg.get([a.reducescatter.remote(mat) for a in ranks], timeout=T)
    _col(pkg).destroy_collective_group("g")
    return out


def broadcast(pkg):
    ranks = _ranks(pkg)
    out = pkg.get([a.broadcast.remote([float(i) * 10], 2)
                   for i, a in enumerate(ranks)], timeout=T)
    _col(pkg).destroy_collective_group("g")
    return out


def ring_permute(pkg):
    ranks = _ranks(pkg)
    out = pkg.get([a.sendrecv_ring.remote([float(i)])
                   for i, a in enumerate(ranks)], timeout=T)
    _col(pkg).destroy_collective_group("g")
    return out


def pairwise_send_recv(pkg):
    # A 2-party exchange inside the 4-rank group must not wait on ranks 2/3.
    col = _col(pkg)

    class P2P:
        def __init__(self, rank):
            self.rank = rank
            col.init_collective_group(WORLD, rank, group_name="p2p")

        def send_to(self, dst, val):
            return np.asarray(col.send(np.float32(val), dst, group_name="p2p"))

        def recv_from(self, src):
            return np.asarray(col.recv(np.zeros(2, np.float32), src,
                                       group_name="p2p"))

    a = [pkg.remote(P2P).remote(i) for i in range(WORLD)]
    s = a[0].send_to.remote(1, [7.0, 8.0])
    r = a[1].recv_from.remote(0)
    out = [pkg.get(r, timeout=30), pkg.get(s, timeout=30)]
    col.destroy_collective_group("p2p")
    return out


def create_collective_group_from_driver(pkg):
    col = _col(pkg)

    class Plain:
        def reduce_val(self, v):
            return float(np.asarray(col.allreduce(np.float32([v]),
                                                  group_name="drv"))[0])

    actors = [pkg.remote(Plain).options(max_concurrency=2).remote()
              for _ in range(3)]
    col.create_collective_group(actors, 3, [0, 1, 2], group_name="drv")
    out = pkg.get([a.reduce_val.remote(i + 1) for i, a in enumerate(actors)],
                  timeout=T)
    col.destroy_collective_group("drv")
    return out


def uninitialized_group_errors(pkg):
    return raises(lambda: _col(pkg).allreduce(np.ones(2), group_name="nope",
                                              rank=0))


@pytest.mark.parametrize("case", [
    allreduce_sum, allreduce_repeated_rounds, allgather, reducescatter,
    broadcast, ring_permute, pairwise_send_recv,
    create_collective_group_from_driver, uninitialized_group_errors,
], ids=lambda f: f.__name__)
def test_matches_reference(case):
    ref, port = both(case)
    assert_same(ref, port)


def _group(pkg, name, world, **kw):
    if pkg is ray_tpu:
        from ray_tpu.collective.xla_group import XLACollectiveGroup

        return XLACollectiveGroup(name, world, **kw)
    from ray_tpu_torch.collective.thread_group import ThreadCollectiveGroup

    return ThreadCollectiveGroup(name, world, **kw)


def _drive(group, fn, world):
    with ThreadPoolExecutor(world) as pool:
        futs = [pool.submit(fn, r) for r in range(world)]
        return [np.asarray(f.result(timeout=60)) for f in futs]


def test_allreduce_product_with_negatives():
    # PRODUCT must be exact for negative inputs (no exp(psum(log)) NaNs).
    vals = [2.0, -3.0, 1.0, -1.0]
    outs = {}
    for pkg in (ray_tpu, ray_tpu_torch):
        group = _group(pkg, "prod", 4)
        op = pkg.collective.ReduceOp.PRODUCT
        outs[pkg.__name__] = _drive(
            group, lambda r: group.allreduce(r, np.float32([vals[r]]), op), 4)
        group.destroy()
    for out in outs["ray_tpu_torch"]:
        np.testing.assert_array_equal(out, np.float32([6.0]))
    assert_same(outs["ray_tpu"], outs["ray_tpu_torch"])


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["sum", "product", "min", "max"])
def test_reductions_match_reference_across_dtypes(op, dtype):
    """Every reduce op of allreduce and reducescatter on the same seeded
    inputs: integers equal and of the same dtype, floats within 1e-6."""
    rng = np.random.default_rng(0)
    world = 4
    ins = rng.integers(-3, 4, (world, world, 5)).astype(dtype)
    outs = {}
    for pkg in (ray_tpu, ray_tpu_torch):
        group = _group(pkg, f"dt-{op}", world)
        outs[pkg.__name__] = [
            _drive(group, lambda r: group.allreduce(r, ins[r][0], op), world),
            _drive(group, lambda r: group.reducescatter(r, ins[r], op), world)]
        group.destroy()
    assert_same(outs["ray_tpu"], outs["ray_tpu_torch"])


def test_bad_backend():
    """Each package refuses a backend it lacks: the reference "nccl", the
    port anything but "nccl" and "gloo"."""
    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        with pytest.raises(ValueError):
            ray_tpu_torch.collective.init_collective_group(2, 0, backend="xla")
        for backend in ("nccl", "gloo"):
            ray_tpu_torch.collective.init_collective_group(
                2, 0, backend=backend, group_name=f"ok-{backend}")
            ray_tpu_torch.collective.destroy_collective_group(
                f"ok-{backend}")
    finally:
        ray_tpu_torch.shutdown()
    fresh_init(ray_tpu, num_cpus=2)
    try:
        with pytest.raises(ValueError):
            ray_tpu.collective.init_collective_group(2, 0, backend="nccl")
    finally:
        ray_tpu.shutdown()



def test_gloo_is_refused_on_an_nccl_process_group(monkeypatch):
    """The process tier's transport is the process group's: a rank whose
    group is NCCL (it holds a card) refuses "gloo" instead of running over
    NCCL, and makes no group; "nccl" there is that group."""
    from ray_tpu_torch.collective import process_group

    class NcclGroup:
        def __init__(self, group_name, world_size, devices, timeout_s=None):
            self.world_size, self.backend = world_size, "nccl"

        def destroy(self):
            pass

    monkeypatch.setattr(process_group, "multiprocess_world", lambda: 1)
    monkeypatch.setattr(process_group, "ProcessCollectiveGroup", NcclGroup)
    col = ray_tpu_torch.collective
    with pytest.raises(ValueError, match="process group is NCCL"):
        col.init_collective_group(1, 0, backend="gloo", group_name="g")
    with pytest.raises(ValueError, match="not initialized"):
        col.get_collective_group("g")
    col.init_collective_group(1, 0, backend="nccl", group_name="n")
    try:
        assert type(col.get_collective_group("n")) is NcclGroup
    finally:
        col.destroy_collective_group("n")

def test_oversubscribed_group_warns_loudly():
    """99 ranks on 8 devices: the reference's 8 CPU devices, the port's
    eight given devices (on the card, its cards)."""
    with pytest.warns(RuntimeWarning, match="host-side"):
        ref = _group(ray_tpu, "oversub", 99)
    with pytest.warns(RuntimeWarning, match="ranks share devices"):
        port = _group(ray_tpu_torch, "oversub", 99,
                      devices=[torch.device("cpu")] * 8)
    assert ref._oversubscribed and port._oversubscribed
    assert len(port.devices) == 99
    ref.destroy()
    port.destroy()


def test_rendezvous_timeout_is_configurable():
    """A lone rank is released after the group's timeout_s, not the 300 s
    default, with the reference's message."""
    for pkg in (ray_tpu, ray_tpu_torch):
        group = _group(pkg, "short-timeout", 2, timeout_s=1.0)
        t0 = time.time()
        err = []

        def lone_rank():
            try:
                group.allreduce(0, np.ones(4))
            except TimeoutError as e:
                err.append(e)

        t = threading.Thread(target=lone_rank)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert err and "rendezvous timed out" in str(err[0]), pkg.__name__
        assert time.time() - t0 < 10, "timeout knob was not honored"
        group.destroy()


def test_destroy_wakes_a_blocked_rank():
    from ray_tpu_torch.collective.thread_group import ThreadCollectiveGroup

    group = ThreadCollectiveGroup("wake", 2, timeout_s=60.0)
    err = []

    def lone():
        try:
            group.allreduce(0, torch.ones(2))
        except RuntimeError as e:
            err.append(str(e))

    t = threading.Thread(target=lone)
    t.start()
    time.sleep(0.2)
    group.destroy()
    t.join(timeout=10)
    assert not t.is_alive() and "was destroyed" in err[0]


def test_destroyed_group_refuses_later_rounds_at_once():
    """A rank that reaches the group after its destruction (a rank of a
    failed attempt still finishing its step) is refused at once instead of
    waiting out the rendezvous timeout for partners that stopped."""
    from ray_tpu_torch.collective.thread_group import ThreadCollectiveGroup

    group = ThreadCollectiveGroup("late", 2, timeout_s=60.0)
    group.destroy()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="was destroyed"):
        group.allreduce(1, torch.ones(2))
    assert time.monotonic() - t0 < 1.0


def test_actor_of_a_reformed_group_is_refused():
    """An actor that joined a group is no member once the group is
    re-formed under its name (the elastic Trainer's next attempt drops the
    old ranks' bindings): its allreduce raises instead of joining the new
    group's rounds."""
    from ray_tpu_torch import collective

    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Rank:
            def __init__(self):
                collective.init_collective_group(1, 0, group_name="reformed")

            def reduce(self):
                return collective.allreduce(torch.ones(2),
                                            group_name="reformed").tolist()

        rank = Rank.remote()
        assert ray_tpu_torch.get(rank.reduce.remote(), timeout=30) == [1, 1]
        collective.reform_collective_group(1, group_name="reformed")
        with pytest.raises(Exception, match="No rank bound"):
            ray_tpu_torch.get(rank.reduce.remote(), timeout=30)
    finally:
        collective.destroy_collective_group("reformed")
        ray_tpu_torch.shutdown()


def test_each_rank_gets_its_own_tensor():
    """Results are private copies: a rank writing into its result (as a
    loop dividing its gradient sum in place does) changes no other rank's."""
    from ray_tpu_torch.collective.thread_group import ThreadCollectiveGroup

    group = ThreadCollectiveGroup("own", 2)

    def rank(r):
        out = group.allreduce(r, torch.full((3,), float(r + 1)))
        out.div_(2)
        group.barrier(r)
        return out

    outs = _drive(group, rank, 2)
    for out in outs:
        np.testing.assert_array_equal(out, np.full(3, 1.5, np.float32))


def test_no_torch_distributed_on_import():
    """Importing the collective and train packages sets up no process
    group; the thread tier never needs one."""
    import torch.distributed as dist

    import ray_tpu_torch.collective  # noqa: F401
    import ray_tpu_torch.train  # noqa: F401

    assert not dist.is_initialized()


def _gloo_rank_ops(pkg_col, world):
    class GlooRank:
        def join(self, addr, rank):
            from ray_tpu_torch.collective import distributed

            self.rank = rank
            backend = distributed.initialize(addr, world, rank)
            pkg_col.init_collective_group(world, rank, group_name="pg")
            return backend

        def ops(self):
            col, r = pkg_col, self.rank
            perm = [(i, (i + 1) % world) for i in range(world)]
            group = col.get_collective_group("pg")
            out = {
                "tier": type(group).__name__,
                "sum": col.allreduce(np.float32([r + 1] * 3), group_name="pg"),
                "prod": col.allreduce(np.float32([[2.0, -3.0][r]]),
                                      group_name="pg",
                                      op=col.ReduceOp.PRODUCT),
                "max": col.allreduce(np.int32([r]), group_name="pg",
                                     op=col.ReduceOp.MAX),
                "gather": col.allgather(np.float32([r]), group_name="pg"),
                "scatter": col.reducescatter(
                    np.arange(world * 2, dtype=np.float32).reshape(world, 2),
                    group_name="pg"),
                "bcast": col.broadcast(np.float32([r * 10]), src_rank=1,
                                       group_name="pg"),
                "ring": group.send_recv(r, np.float32([r]), perm),
                "ops": dict(group.ops),
            }
            col.barrier(group_name="pg")
            return {k: np.asarray(v) if not isinstance(v, (str, dict)) else v
                    for k, v in out.items()}

        def leave(self):
            from ray_tpu_torch.collective import distributed

            pkg_col.destroy_collective_group("pg")
            distributed.shutdown()

    return GlooRank


def test_process_tier_over_gloo_matches_thread_tier():
    """Two worker processes joined into one gloo group: the same ops through
    the same call surface give the thread tier's answers."""
    from ray_tpu_torch.train.trainer import _reserve_addr

    world = 2
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        cls = ray_tpu_torch.remote(_gloo_rank_ops(ray_tpu_torch.collective,
                                                  world))
        ranks = [cls.options(isolation="process").remote()
                 for _ in range(world)]
        addr = _reserve_addr()
        backends = ray_tpu_torch.get(
            [a.join.remote(addr, r) for r, a in enumerate(ranks)], timeout=120)
        outs = ray_tpu_torch.get([a.ops.remote() for a in ranks], timeout=120)
        ray_tpu_torch.get([a.leave.remote() for a in ranks], timeout=60)
    finally:
        ray_tpu_torch.shutdown()
    assert backends == ["gloo", "gloo"]
    for r, out in enumerate(outs):
        assert out["tier"] == "ProcessCollectiveGroup"
        np.testing.assert_array_equal(out["sum"], np.float32([3, 3, 3]))
        np.testing.assert_array_equal(out["prod"], np.float32([-6.0]))
        assert out["max"].dtype == np.int32 and out["max"].tolist() == [1]
        np.testing.assert_array_equal(out["gather"], np.float32([[0], [1]]))
        np.testing.assert_array_equal(
            out["scatter"],
            (np.arange(4, dtype=np.float32).reshape(2, 2) * world)[r])
        np.testing.assert_array_equal(out["bcast"], np.float32([10]))
        np.testing.assert_array_equal(out["ring"], np.float32([1 - r]))
        assert out["ops"]["allreduce"] == 3


def test_rendezvous_stress_many_rounds_many_threads():
    """8 thread ranks (more than a small host's cores) through 200 rounds
    of allreduce and allgather with a tiny switch interval: every round's
    answer is exact, so no contribution is lost or read twice."""
    import sys

    from ray_tpu_torch.collective.thread_group import ThreadCollectiveGroup

    world, rounds = 8, 200
    group = ThreadCollectiveGroup("stress", world, timeout_s=60.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def rank(r):
            out = []
            for i in range(rounds):
                s = group.allreduce(r, torch.tensor([r + i], dtype=torch.int64))
                g = group.allgather(r, torch.tensor([r * i]))
                out.append((int(s), g.tolist()))
            return out

        with ThreadPoolExecutor(world) as pool:
            futs = [pool.submit(rank, r) for r in range(world)]
            outs = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
        group.destroy()
    for out in outs:
        for i, (s, g) in enumerate(out):
            assert s == sum(range(world)) + world * i
            assert g == [[r * i] for r in range(world)]
