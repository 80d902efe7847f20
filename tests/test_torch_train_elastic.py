"""Elastic training on the port: the reference's end-to-end cases of
tests/test_train_elastic.py (:262-468) with their toy loop written in
torch, the sample ledger and ``ElasticDatasetShard`` against the
reference's, and a tiny GPT-2 that shrinks and grows.

The end-to-end cases drive a virtual cluster whose head holds no CPU, so
every rank lands on a preemptible worker node, and run ``fit()`` on a
thread while the test kills and adds nodes — the reference's topology.
Their sleeps and joins are the reference's, shortened where the port's
thread ranks reach the same point sooner; every case is bounded well under
a minute. The soak case stays ``slow``, as the reference's.

Tolerances: the ledger parity is exact (claims, counts); the toy loop's
sums are of integers in float64 and are compared exactly, its momentum
replay within 1e-9 relative (float64 sums in another order); the GPT-2
case's first loss after the restore is held to a direct forward of the
restored parameters on the same rows within 1e-6 relative, and its
restored state to the committed one bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init

REPLICA_MEMORY_STEPS = 2
JOIN_S = 90  # the most one fit() may take here


def _set_chaos(spec: str) -> None:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.fault_injection import reset_injector

    GLOBAL_CONFIG.testing_rpc_failure = spec
    reset_injector()


# --------------------------------------------------- ledger and shard parity
class _Session:
    """What ElasticDatasetShard reads of a session."""

    def __init__(self):
        self.step = 0
        self.stop_requested = threading.Event()

    def current_checkpoint_step(self):
        return self.step


def _shard_script(pkg, seed):
    """Two shards over one ledger through seeded claims, seals, rollbacks,
    a fence and a clean finish; returns what each call returned."""
    from importlib import import_module

    elastic = import_module(pkg.__name__ + ".train.elastic")
    rng = np.random.default_rng(seed)
    data = np.arange(100, 160, dtype=np.float64)
    ledger = elastic.SampleLedger(data)
    sessions = [_Session(), _Session()]
    shards = [elastic.ElasticDatasetShard(ledger, s) for s in sessions]
    log = [len(shards[0])]
    for _ in range(40):
        op = int(rng.integers(0, 6))
        who = int(rng.integers(0, 2))
        if op <= 2:
            got = shards[who].next_batch(int(rng.integers(1, 5)))
            log.append(None if got is None
                       else [list(got[0]), np.asarray(got[1]).tolist()])
        elif op == 3:
            sessions[who].step += 1
            log.append(("seal", ledger.seal(sessions[who].step - 1)))
        elif op == 4:
            restore = int(rng.integers(-1, 3))
            log.append(("rollback",
                        ledger.rollback(None if restore < 0 else restore)))
        else:
            sessions[who].stop_requested.set()
            log.append(("fenced", shards[who].next_batch(2)))
            sessions[who].stop_requested.clear()
        log.append((ledger.remaining(), ledger.inflight(),
                    sorted(ledger.trained_counts().items())))
    rest = [b for b in shards[0].iter_batches(7)]
    log.append([[list(i), np.asarray(x).tolist()] for i, x in rest])
    log.append(("seal_all", ledger.seal_all()))
    log.append((ledger.double_trained(), ledger.untrained(),
                ledger.exhausted()))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_elastic_shard_matches_reference(seed):
    """The same claims, seals, rollbacks and fences give the same batches,
    counts and trained ledger on both packages (exact)."""
    assert _shard_script(ray_tpu_torch, seed) == _shard_script(ray_tpu, seed)


# ------------------------------------------------------- the toy loop
def _elastic_loop(config):
    """Lockstep loop over the elastic shard (the reference's
    ``_elastic_loop`` in torch): every step each rank claims a batch and the
    group allreduces [n_claimed, sum(batch)]; the loop ends when the global
    claim count is zero. The state carries a momentum accumulator and a
    generator's state advanced once a step, so restores show on both."""
    from ray_tpu_torch import collective, train

    ctx = train.get_context()
    mu = config.get("momentum", 0.0)
    sleep_s = config.get("sleep", 0.05)
    gen = torch.Generator()
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t = ckpt.to_pytree()
        w, m, step = float(t["w"]), float(t["m"]), int(t["step"])
        gen.set_state(t["key"])
    else:
        w, m, step = 0.0, 0.0, -1
        gen.manual_seed(config.get("seed", 0))
    shard = train.get_dataset_shard("train")
    while True:
        batch = shard.next_batch(config.get("batch", 2))
        n = 0 if batch is None else len(batch[0])
        contrib = 0.0 if batch is None else float(np.sum(batch[1]))
        vec = collective.allreduce(
            torch.tensor([float(n), contrib], dtype=torch.float64),
            group_name=ctx.collective_group)
        if float(vec[0]) == 0:
            break
        g = float(vec[1])
        m = mu * m + g
        w = w + m
        step += 1
        draw = int(torch.randint(0, 1 << 30, (1,), generator=gen))
        train.report(
            {"step": step, "g": g, "w": w, "m": m, "world": ctx.world_size,
             "draw": draw},
            checkpoint={"w": torch.tensor(w, dtype=torch.float64),
                        "m": torch.tensor(m, dtype=torch.float64),
                        "step": torch.tensor(step),
                        "key": gen.get_state()})
        time.sleep(sleep_s)


#: weak references to each rank's state, by attempt (the thread ranks
#: share this process)
_BALLAST = {}


def _ballast_loop(config):
    """The toy loop with a state a rank holds in its frame; each resumed
    attempt counts the earlier attempts' states still alive."""
    import gc
    import weakref

    from ray_tpu_torch import train

    ctx = train.get_context()
    attempt = config["attempts"]
    attempt.setdefault(ctx.world_size, len(attempt))
    ballast = torch.ones(1 << 16)
    _BALLAST.setdefault(attempt[ctx.world_size], []).append(
        weakref.ref(ballast))
    if train.get_checkpoint() is not None and ctx.world_rank == 0:
        gc.collect()
        config["alive"].append(sum(
            r() is not None for a, refs in _BALLAST.items()
            if a < attempt[ctx.world_size] for r in refs))
    _elastic_loop(config)


def _make_trainer(tmp_path, data, num_workers=3, min_workers=1,
                  max_failures=3, loop_config=None, name="elastic",
                  grow_check_period_s=0.3, loop=_elastic_loop):
    from ray_tpu_torch.train import (CheckpointConfig, CudaTrainer,
                                     ElasticConfig, FailureConfig, RunConfig,
                                     ScalingConfig)

    return CudaTrainer(
        loop,
        train_loop_config=loop_config or {},
        scaling_config=ScalingConfig(
            num_workers=num_workers, use_gpu=False, worker_mode="threads",
            elastic=ElasticConfig(min_workers=min_workers,
                                  grow_check_period_s=grow_check_period_s)),
        datasets={"train": data},
        run_config=RunConfig(
            name=name, storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(
                async_save=True,
                replica_memory_steps=REPLICA_MEMORY_STEPS),
            failure_config=FailureConfig(max_failures=max_failures)))


def _fit_in_thread(trainer):
    box = {}

    def run():
        box["result"] = trainer.fit()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _assert_exactly_once(trainer, result, data, check_w=True):
    led = trainer.sample_ledgers["train"]
    assert led.double_trained() == [], "samples trained twice"
    assert led.untrained() == [], "samples dropped"
    if check_w:  # momentum-free loop: the final w IS the dataset sum
        assert result.metrics["w"] == float(np.sum(data))


@pytest.fixture
def elastic_cluster():
    """A head with no CPU and three 1-CPU worker nodes: every rank lands on
    a preemptible node, so killing one drops capacity."""
    from ray_tpu_torch.cluster_utils import Cluster

    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 0})
    nodes = [cluster.add_node(num_cpus=1) for _ in range(3)]
    yield cluster, nodes
    ray_tpu_torch.shutdown()
    _set_chaos("")


def _joined(t, box, what):
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), f"fit() hung {what}"
    r = box["result"]
    assert r.error is None, r.error
    return r


def _wait_for_steps(trainer_box_check, n, timeout=30):
    """Wait until the run's registry row shows ``n`` committed steps."""
    deadline = time.monotonic() + timeout
    while not trainer_box_check(n):
        assert time.monotonic() < deadline, "the run never got going"
        time.sleep(0.05)


def _committed_at_least(name):
    from ray_tpu_torch.train import run_registry

    def check(n):
        row = run_registry.get_run(name)
        step = None if row is None else row.get("last_committed_step")
        return step is not None and step >= n

    return check


def test_shrink_on_node_preemption_exactly_once(elastic_cluster, tmp_path):
    """A worker node killed mid-run: the group shrinks to the survivors,
    restores the last committed step, reshards, and finishes with every
    sample trained exactly once."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 241, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="shrink")
    t, box = _fit_in_thread(trainer)
    _wait_for_steps(_committed_at_least("shrink"), 2)
    assert simulate_preemption(str(nodes[0])) is not None
    r = _joined(t, box, "after preemption")
    shrinks = [e for e in r.elastic_events if e["type"] == "shrink"]
    assert shrinks, r.elastic_events
    assert shrinks[0]["from_world"] == 3 and shrinks[0]["to_world"] == 2
    for e in r.elastic_events:
        assert e.get("lost_steps", 0) <= REPLICA_MEMORY_STEPS, e
    _assert_exactly_once(trainer, r, data)
    assert r.metrics["world"] == 2


def test_shrink_then_grow_full_cycle(elastic_cluster, tmp_path):
    """Capacity returns mid-run: the trainer grows back to the target world
    at a checkpoint boundary and still trains every sample exactly once."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 481, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="cycle")
    t, box = _fit_in_thread(trainer)
    _wait_for_steps(_committed_at_least("cycle"), 2)
    assert simulate_preemption(str(nodes[0])) is not None
    time.sleep(1.0)
    cluster.add_node(num_cpus=1)
    r = _joined(t, box, "across shrink and grow")
    kinds = [e["type"] for e in r.elastic_events]
    assert "shrink" in kinds and "grow" in kinds, r.elastic_events
    grow = next(e for e in r.elastic_events if e["type"] == "grow")
    assert grow["from_world"] == 2 and grow["to_world"] == 3
    assert grow["restore_step"] is not None
    assert {m["world"] for m in r.metrics_history} == {2, 3}
    _assert_exactly_once(trainer, r, data)


def test_multihop_preserves_momentum_and_rng(elastic_cluster, tmp_path):
    """shrink -> grow -> shrink in one fit(): the momentum accumulator and
    the generator's chain come out exactly as one lineage's replay of the
    per-step gradients."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 721, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="multihop",
                            loop_config={"momentum": 0.9, "seed": 7})
    t, box = _fit_in_thread(trainer)
    check = _committed_at_least("multihop")
    _wait_for_steps(check, 2)
    assert simulate_preemption(None) is not None          # hop 1: shrink
    time.sleep(1.0)
    cluster.add_node(num_cpus=1)                          # hop 2: grow
    deadline = time.monotonic() + 30
    while not any(e["type"] == "grow" for e in
                  ray_tpu_torch.train.run_registry.get_run("multihop")
                  .get("events", [])):
        assert time.monotonic() < deadline, "never grew"
        time.sleep(0.05)
    time.sleep(1.0)
    assert simulate_preemption(None) is not None          # hop 3: shrink
    r = _joined(t, box, "across multi-hop resize")
    assert len([e for e in r.elastic_events if e["type"] == "shrink"]) >= 2
    assert any(e["type"] == "grow" for e in r.elastic_events)
    # Rolled-back steps are re-reported: the last report of each step is
    # the one whose update survived into the final state.
    by_step = {row["step"]: row for row in r.metrics_history}
    final_step = r.metrics["step"]
    assert sorted(by_step) == list(range(final_step + 1))
    lineage_g = [by_step[s]["g"] for s in range(final_step + 1)]
    assert sum(lineage_g) == float(np.sum(data))
    _assert_exactly_once(trainer, r, data, check_w=False)
    w = m = 0.0
    for g in lineage_g:
        m = 0.9 * m + g
        w = w + m
    assert r.metrics["m"] == pytest.approx(m, rel=1e-9)
    assert r.metrics["w"] == pytest.approx(w, rel=1e-9)
    # The generator advanced once a step from the seed, never forked or
    # replayed by the restores.
    gen = torch.Generator()
    gen.manual_seed(7)
    draws = [int(torch.randint(0, 1 << 30, (1,), generator=gen))
             for _ in range(final_step + 1)]
    assert [by_step[s]["draw"] for s in range(final_step + 1)] == draws


def test_failed_attempt_state_is_freed_before_the_next(elastic_cluster,
                                                     tmp_path):
    """The ranks of a failed attempt stop, and their state goes with them:
    when the shrunken attempt resumes, no earlier attempt's tensor is still
    alive (a rank's error keeps its message, not its frames)."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    _BALLAST.clear()
    config = {"attempts": {}, "alive": []}
    data = np.arange(1, 241, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="ballast",
                            loop=_ballast_loop, loop_config=config)
    t, box = _fit_in_thread(trainer)
    _wait_for_steps(_committed_at_least("ballast"), 1)
    assert simulate_preemption(str(nodes[0])) is not None
    r = _joined(t, box, "after preemption")
    assert [e["type"] for e in r.elastic_events] == ["shrink"]
    assert config["alive"] == [0], config["alive"]
    _assert_exactly_once(trainer, r, data)


def test_replica_holder_node_preempted_falls_back(elastic_cluster, tmp_path):
    """The node hosting the in-memory replica holder is preempted: the
    restore falls back (peer payloads or the committed dir) within a bound
    instead of hanging on the dead holder."""
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 361, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="holder")
    t, box = _fit_in_thread(trainer)
    runtime = get_runtime()
    holder_node = None
    deadline = time.time() + 20
    while time.time() < deadline and holder_node is None:
        for st in list(runtime._actors.values()):
            if (st.spec.cls.__name__ == "ReplicaHolder"
                    and st.state == "ALIVE" and st.node_id is not None):
                holder_node = str(st.node_id)
                break
        time.sleep(0.05)
    assert holder_node is not None, "replica holder never spawned"
    killed_at = time.monotonic()
    assert simulate_preemption(holder_node) is not None
    r = _joined(t, box, "restoring without its holder")
    assert r.elastic_events, "holder-node loss went unnoticed"
    for e in r.elastic_events:
        assert e.get("lost_steps", 0) <= REPLICA_MEMORY_STEPS, e
    assert time.monotonic() - killed_at < 60
    _assert_exactly_once(trainer, r, data)


def test_injected_worker_crash_recovers(elastic_cluster, tmp_path):
    """train_worker_run fault point: one rank dies at a step boundary; the
    elastic controller recovers inside the same fit()."""
    _set_chaos("train_worker_run=1.0:1")
    data = np.arange(1, 121, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="crash")
    r = bounded(trainer.fit, JOIN_S)
    assert r.error is None, r.error
    assert r.elastic_events, "injected crash produced no elastic event"
    _assert_exactly_once(trainer, r, data)


def test_preempt_node_fault_point_shrinks(elastic_cluster, tmp_path):
    """preempt_node fault point: the controller's tick itself preempts a
    worker-group node and the run shrinks."""
    _set_chaos("preempt_node=1.0:1")
    data = np.arange(1, 181, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, name="faultpoint")
    r = bounded(trainer.fit, JOIN_S)
    assert r.error is None, r.error
    shrinks = [e for e in r.elastic_events if e["type"] == "shrink"]
    assert shrinks and shrinks[0]["to_world"] == 2, r.elastic_events
    _assert_exactly_once(trainer, r, data)


def test_capacity_below_min_workers_is_a_failure(elastic_cluster, tmp_path):
    """A recovery below ElasticConfig.min_workers does not mask the loss:
    it consumes max_failures and surfaces the error."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 961, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, num_workers=3, min_workers=3,
                            max_failures=0, name="below")
    t, box = _fit_in_thread(trainer)
    _wait_for_steps(_committed_at_least("below"), 1)
    assert simulate_preemption(str(nodes[0])) is not None
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), "fit() hung instead of failing fast"
    assert box["result"].error is not None, \
        "capacity below min_workers must exhaust max_failures"


def test_elastic_requires_thread_tier(tmp_path):
    """Process ranks cannot share the controller's ledger or re-form groups
    in place: elastic with worker_mode='processes' is refused."""
    from ray_tpu_torch.train import (CudaTrainer, ElasticConfig, RunConfig,
                                     ScalingConfig)

    fresh_init(ray_tpu_torch, num_cpus=8)
    try:
        r = CudaTrainer(
            _elastic_loop,
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=False, worker_mode="processes",
                elastic=ElasticConfig(min_workers=1)),
            datasets={"train": np.arange(8, dtype=np.float64)},
            run_config=RunConfig(name="badmode",
                                 storage_path=str(tmp_path))).fit()
        assert isinstance(r.error, ValueError)
        assert "thread" in str(r.error)
    finally:
        ray_tpu_torch.shutdown()


def test_chaos_acceptance_three_kills_one_fit(elastic_cluster, tmp_path):
    """Three node kills inside one fit(): no sample double-trained or
    dropped, every recovery's lost steps within replica_memory_steps, and
    the world grows back once capacity returns."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 1441, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, max_failures=6, name="chaos",
                            loop_config={"sleep": 0.02})
    t, box = _fit_in_thread(trainer)
    _wait_for_steps(_committed_at_least("chaos"), 1)
    kills = 0
    for _ in range(3):
        time.sleep(0.7)
        if simulate_preemption(None) is not None:
            kills += 1
        time.sleep(0.7)
        cluster.add_node(num_cpus=1)
    assert kills == 3
    r = _joined(t, box, "during chaos")
    events = r.elastic_events
    assert len([e for e in events if e["type"] in ("shrink", "recover")]) >= 3
    grows = [e for e in events if e["type"] == "grow"]
    assert grows and grows[-1]["to_world"] == 3, events
    for e in events:
        assert e.get("lost_steps", 0) <= REPLICA_MEMORY_STEPS, e
        if "recovery_seconds" in e:
            assert e["recovery_seconds"] < 60
    _assert_exactly_once(trainer, r, data)


@pytest.mark.slow
def test_elastic_soak_sustained_preemption(elastic_cluster, tmp_path):
    """Soak: kill and re-add nodes for the whole run; exactly once and the
    lost-step bound hold over many recoveries."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption

    cluster, nodes = elastic_cluster
    data = np.arange(1, 4801, dtype=np.float64)
    trainer = _make_trainer(tmp_path, data, max_failures=20, name="soak",
                            loop_config={"sleep": 0.03})
    t, box = _fit_in_thread(trainer)
    kills = 0
    while t.is_alive() and kills < 8:
        time.sleep(1.5)
        if simulate_preemption(None) is not None:
            kills += 1
        time.sleep(1.0)
        cluster.add_node(num_cpus=1)
    t.join(timeout=600)
    assert not t.is_alive()
    r = box["result"]
    assert r.error is None, r.error
    assert kills >= 5
    for e in r.elastic_events:
        assert e.get("lost_steps", 0) <= REPLICA_MEMORY_STEPS, e
    _assert_exactly_once(trainer, r, data)


# ------------------------------------------------------ tiny GPT-2, elastic
def test_gpt2_tiny_shrinks_and_grows_exactly_once(tmp_path):
    """GPT-2 tiny (2 layers, d_model 64, float32; the reference's initial
    weights through ``models.convert``) trains through ``CudaTrainer`` on
    two 1-CPU nodes over a sized dataset of S + 1-id rows. Once a step has
    committed, the ``preempt_node`` fault point takes a rank's node: the
    world shrinks 2 -> 1 and restores the newest committed step from the
    memory replicas, bit for bit; a node added back grows it to 2. Every
    row trains exactly once, and the first step after the restore has the
    loss of a direct forward of the restored parameters on its rows
    (within 1e-6 relative; and the reference's forward within 1e-4)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.examples import train_gpt2
    from ray_tpu_torch.models import convert, gpt2
    from ray_tpu_torch.optim import tree_leaves
    from ray_tpu_torch.train import (CheckpointConfig, CudaTrainer,
                                     ElasticConfig, FailureConfig, RunConfig,
                                     ScalingConfig, run_registry)

    jcfg = dataclasses.replace(
        jgpt2.GPTConfig.tiny(), dtype=jnp.float32, logits_dtype=jnp.float32,
        loss_impl="fused", remat_policy="attn_outside", **train_gpt2.TINY)
    init = jax.tree.map(np.asarray, jgpt2.init_params(jcfg,
                                                      jax.random.key(0)))
    S = train_gpt2.TINY["seq_len"]
    rows = np.random.default_rng(0).integers(
        0, train_gpt2.TINY["vocab_size"], (96, S + 1), dtype=np.int64)
    seen = {"restore": [], "checkpoint": {}, "first": None}
    lock = threading.Lock()

    def leaves(state):
        return [t.detach().clone() for t in
                tree_leaves(state["params"]) +
                tree_leaves(state["opt_state"]["mu"]) +
                tree_leaves(state["opt_state"]["nu"])]

    def probe(event, rank, step, **info):
        with lock:
            if event == "restore" and rank == 0:
                seen["restore"].append(
                    (step, leaves(info["state"]), jax.tree.map(
                        np.array,  # copies: the loop updates in place
                        convert.params_to_numpy(info["state"]["params"]))))
            elif event == "checkpoint" and rank == 0:
                seen["checkpoint"].setdefault(step, leaves(info["state"]))
            elif event == "step" and seen["restore"] and \
                    seen["first"] is None and step == seen["restore"][-1][0] + 1:
                seen["first"] = (rank, info["loss"],
                                 info["tokens"].detach().clone())

    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 0})
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=1)
        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=dict(batch_size=4, tiny=True, device="cpu",
                                   init_params=init, lr=1e-3, ckpt_every=2,
                                   async_save=True, probe=probe),
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=False, worker_mode="threads",
                elastic=ElasticConfig(min_workers=1,
                                      grow_check_period_s=0.3)),
            datasets={"train": rows},
            run_config=RunConfig(
                name="gpt2-elastic", storage_path=str(tmp_path),
                checkpoint_config=CheckpointConfig(
                    async_save=True, replica_memory_steps=2),
                failure_config=FailureConfig(max_failures=2)))
        t, box = _fit_in_thread(trainer)
        _wait_for_steps(_committed_at_least("gpt2-elastic"), 0, timeout=60)
        _set_chaos("preempt_node=1.0:1")
        deadline = time.monotonic() + 60
        while not run_registry.get_run("gpt2-elastic")["events"]:
            assert time.monotonic() < deadline, "no shrink"
            time.sleep(0.05)
        _set_chaos("")
        cluster.add_node(num_cpus=1)
        r = _joined(t, box, "across the GPT-2 shrink and grow")
    finally:
        ray_tpu_torch.shutdown()
        _set_chaos("")
    kinds = [(e["type"], e["from_world"], e["to_world"])
             for e in r.elastic_events]
    assert kinds[0] == ("shrink", 2, 1), kinds
    assert ("grow", 1, 2) in kinds, kinds
    led = trainer.sample_ledgers["train"]
    assert led.double_trained() == [] and led.untrained() == []
    restored_step, restored, restored_np = seen["restore"][0]
    shrink = r.elastic_events[0]
    assert restored_step == 2 * (shrink["restore_step"] + 1)
    for a, b in zip(restored, seen["checkpoint"][restored_step]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, loss, tok = seen["first"]
    cfg = train_gpt2.model_config(tiny=True)
    params = convert.params_from_numpy(restored_np, device="cpu")
    direct = float(gpt2.loss_fn(params, tok[:, :S], tok[:, 1:], cfg))
    assert abs(loss - direct) <= 1e-6 * abs(direct), (loss, direct)
    ref = float(jgpt2.loss_fn(jax.tree.map(jnp.asarray, restored_np),
                              jnp.asarray(tok[:, :S].numpy()),
                              jnp.asarray(tok[:, 1:].numpy()), jcfg))
    assert abs(loss - ref) <= 1e-4, (loss, ref)
