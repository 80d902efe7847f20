"""The slice as a whole: GPT-2 trained through the port's Train API
(``ray_tpu_torch.examples.train_gpt2``'s loop in ``CudaTrainer``) against
the reference's ``JaxTrainer`` running the same loop in JAX.

Both sides get the same tiny GPT-2 in fp32 (2 layers, d_model 64, 4 heads,
S=32, V=1024, ``loss_impl="fused"``, ``remat_policy="attn_outside"``), the
same weights (JAX's init, as numpy, through ``models.convert``) and the same
per-rank numpy batches; two thread ranks all-reduce their gradients and
step AdamW (optax's on the JAX side, ``ray_tpu_torch.optim``'s on the
port's). Every rank's loss at every step and the final parameters must
agree within 1e-4. Then: two gloo worker processes whose gradients really
sync, a resume from a checkpoint that equals the run it interrupted, and
the example's command line at the tiny size.
"""

import dataclasses
import os
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused
from ray_tpu_torch.examples import train_gpt2

TOL = 1e-4
W, B, STEPS, LR = 2, 4, 3, 1e-3
CASE_S = 300


def _jcfg():
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2

    return dataclasses.replace(
        jgpt2.GPTConfig.tiny(), dtype=jnp.float32, logits_dtype=jnp.float32,
        loss_impl="fused", remat_policy="attn_outside", **train_gpt2.TINY)


@pytest.fixture(scope="module")
def init():
    import jax

    from ray_tpu.models import gpt2 as jgpt2

    return jax.tree.map(np.asarray, jgpt2.init_params(_jcfg(),
                                                      jax.random.key(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, train_gpt2.TINY["vocab_size"],
        (W * B * STEPS, train_gpt2.TINY["seq_len"] + 1), dtype=np.int64)


def _leaves_with_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _jax_fit(init, tokens):
    """The reference's loop (tests/test_train.py:66-107's pattern) on the
    same rows: value_and_grad, allreduce of the flat gradients, their mean,
    optax AdamW."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu import collective, train
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.train import JaxTrainer, ScalingConfig

    cfg = _jcfg()
    S = cfg.seq_len
    losses, final = {}, {}

    def loop(config):
        ctx = train.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        params = jax.tree.map(jnp.asarray, init)
        opt = jgpt2.make_optimizer(LR)
        state = opt.init(params)
        vg = jax.jit(jax.value_and_grad(
            lambda p, a, b: jgpt2.loss_fn(p, a, b, cfg)))
        flat = jax.jit(lambda g: jnp.concatenate(
            [x.ravel() for x in jax.tree.leaves(g)]))

        @jax.jit
        def apply(params, state, summed):
            avg = summed / world
            leaves, tree = jax.tree.flatten(params)
            out, i = [], 0
            for p in leaves:
                out.append(avg[i:i + p.size].reshape(p.shape))
                i += p.size
            updates, state = opt.update(jax.tree.unflatten(tree, out), state,
                                        params)
            return optax.apply_updates(params, updates), state

        for i in range(STEPS):
            rows = (np.arange(B * world) + i * B * world) % len(tokens)
            tok = tokens[rows[rank * B:(rank + 1) * B]]
            loss, g = vg(params, tok[:, :S], tok[:, 1:])
            summed = collective.allreduce(flat(g),
                                          group_name=ctx.collective_group)
            params, state = apply(params, state, summed)
            losses[(rank, i + 1)] = float(loss)
            train.report({"step": i + 1, "loss": float(loss)})
        final[rank] = jax.tree.map(np.asarray, params)

    result = JaxTrainer(loop, scaling_config=ScalingConfig(
        num_workers=W)).fit()
    return result, losses, final


def _port_fit(init, tokens, **extra):
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    losses, final = {}, {}

    def probe(event, rank, step, **info):
        if event == "step":
            losses[(rank, step)] = info["loss"]
            final[rank] = {n: t.detach().clone().numpy()
                           for n, t in _leaves_with_names(info["params"])}

    config = dict(steps=STEPS, batch_size=B, tiny=True, device="cpu",
                  init_params=init, tokens=tokens, lr=LR, probe=probe)
    config.update(extra)
    result = CudaTrainer(
        train_gpt2.train_loop_per_worker, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=W, use_gpu=False),
        run_config=RunConfig(storage_path=tempfile.mkdtemp())).fit()
    return result, losses, final


def test_gpt2_tiny_fit_matches_jax_trainer(init, tokens):
    with gc_paused():
        fresh_init(ray_tpu, num_cpus=4)
        try:
            ref, ref_losses, ref_final = bounded(
                lambda: _jax_fit(init, tokens), CASE_S)
        finally:
            ray_tpu.shutdown()
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        port, losses, final = bounded(lambda: _port_fit(init, tokens), CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert ref.error is None and port.error is None, (ref.error, port.error)
    assert sorted(losses) == sorted(ref_losses)
    for key in ref_losses:
        assert abs(losses[key] - ref_losses[key]) <= TOL, \
            (key, losses[key], ref_losses[key])
    assert [m["step"] for m in port.metrics_history] == [1, 2, 3]
    for rank in range(W):
        for name, want in _leaves_with_names(ref_final[rank]):
            np.testing.assert_allclose(final[rank][name], want, rtol=0,
                                       atol=TOL, err_msg=f"{rank} {name}")
    # The ranks' gradients were the same mean: their weights are equal.
    for name, p0 in final[0].items():
        np.testing.assert_array_equal(p0, final[1][name])



def test_probe_sees_each_rank_gradient_before_and_after_the_allreduce(
        init, tokens):
    """The loop's probe gets each rank's batch rows and its own gradient
    besides the mean: the mean over ranks of the own gradients is the
    reduced one, and no rank's own gradient is it (what the card's parity
    gate reads as its control)."""
    from ray_tpu_torch.optim import tree_leaves

    seen = {}

    def probe(event, rank, step, **info):
        if event == "step":
            seen[rank] = (info["rows"],
                          [t.detach().clone() for t in
                           tree_leaves(info["local_grads"])],
                          [t.detach().clone() for t in
                           tree_leaves(info["grads"])])

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        result, _, _ = bounded(lambda: _port_fit(init, tokens, steps=1,
                                                 probe=probe), CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    assert sorted(seen) == list(range(W))
    assert [seen[r][0] for r in range(W)] == [B] * W
    for i, mean in enumerate(seen[0][2]):
        own = [seen[r][1][i] for r in range(W)]
        torch.testing.assert_close(sum(own) / W, mean, rtol=0, atol=1e-6)
        torch.testing.assert_close(seen[1][2][i], mean, rtol=0, atol=0)
    assert any(not torch.allclose(seen[0][1][i], mean, rtol=0, atol=1e-4)
               for i, mean in enumerate(seen[0][2]))

def test_two_gloo_processes_sync_their_gradients(init, tokens):
    """Two process ranks on gloo (worker_mode="processes"): after one step
    their parameters are equal, and equal one process's step on the
    concatenated batch."""
    from ray_tpu_torch.models import convert, gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    out_dir = tempfile.mkdtemp()

    def probe(event, rank, step, **info):
        import os as _os

        import torch as _torch

        if event == "step":
            p = info["params"]
            flat = {k: v for k, v in p.items() if k != "blocks"}
            flat.update({f"blocks.{k}": v for k, v in p["blocks"].items()})
            _torch.save({k: v.detach() for k, v in flat.items()},
                        _os.path.join(out_dir, f"rank{rank}.pt"))

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=dict(steps=1, batch_size=B, tiny=True,
                                   device="cpu", init_params=init,
                                   tokens=tokens, lr=LR, probe=probe,
                                   diagnostics=True),
            scaling_config=ScalingConfig(num_workers=W, use_gpu=False,
                                         worker_mode="processes"),
            run_config=RunConfig(storage_path=tempfile.mkdtemp()))
        result = bounded(trainer.fit, CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    assert [t["backend"] for t in trainer.process_topology] == ["gloo"] * W
    assert result.metrics["pid"] != os.getpid()
    assert result.metrics["collective_ops"] == {"allreduce": 1}
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(W)]
    for name in got[0]:
        assert torch.equal(got[0][name], got[1][name]), name

    cfg = train_gpt2.model_config(tiny=True)
    params = convert.params_from_numpy(init, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tok = torch.as_tensor(tokens[:W * B])
    loss = gpt2.loss_fn(params, tok[:, :cfg.seq_len], tok[:, 1:], cfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    opt = gpt2.make_optimizer(LR)
    opt.update(tree_map(lambda _: next(grads), params), opt.init(params),
               params)
    for name, want in _leaves_with_names(params):
        np.testing.assert_allclose(got[0][name].numpy(),
                                   want.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_resume_from_checkpoint_continues_the_run(init, tokens):
    """One rank, a checkpoint every 2 steps (two kept), a failure after step
    3 of the first attempt: the restart restores the step-2 checkpoint bit
    for bit, and every step's loss equals an uninterrupted run's."""
    from ray_tpu_torch.optim import tree_leaves
    from ray_tpu_torch.train import (
        CheckpointConfig,
        CudaTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )

    def fit(**extra):
        seen = {"restore": [], "checkpoint": []}

        def probe(event, rank, step, **info):
            if event in seen:
                state = info["state"]
                seen[event].append((step, [
                    t.detach().clone() for t in
                    tree_leaves(state["params"]) +
                    tree_leaves(state["opt_state"]["mu"]) +
                    tree_leaves(state["opt_state"]["nu"])]))

        config = dict(steps=6, batch_size=B, tiny=True, device="cpu",
                      init_params=init, tokens=tokens, lr=LR,
                      ckpt_every=2, probe=probe, **extra)
        result = CudaTrainer(
            train_gpt2.train_loop_per_worker, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(
                storage_path=tempfile.mkdtemp(),
                checkpoint_config=CheckpointConfig(num_to_keep=2),
                failure_config=FailureConfig(max_failures=1))).fit()
        return result, seen

    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        broken, seen = bounded(lambda: fit(fail_at_step=3), CASE_S)
        whole, _ = bounded(fit, CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert broken.error is None and len(broken.restarts) == 1
    assert [m["step"] for m in broken.metrics_history] == [1, 2, 3, 3, 4, 5, 6]
    (restored_step, restored), = seen["restore"]
    saved = dict(seen["checkpoint"])[restored_step]
    assert restored_step == 2
    for a, b in zip(restored, saved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = {m["step"]: m["loss"] for m in whole.metrics_history}
    got = [(m["step"], m["loss"]) for m in broken.metrics_history]
    assert all(loss == want[step] for step, loss in got), (got, want)
    kept = os.listdir(os.path.dirname(broken.checkpoint.path))
    assert len(kept) == 2 and broken.checkpoint.to_pytree()["step"] == 6


def test_example_runs_on_the_cpu(capsys):
    ray_tpu_torch.shutdown()
    assert train_gpt2.main(["--device", "cpu", "--tiny", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "train_gpt2 workers=2 steps=2" in out and out.rstrip().endswith("OK")


def test_streaming_ingest_with_uneven_shards(init):
    """Two ranks read one streaming dataset of 3 blocks: their shard counts
    differ, and the rank that runs out keeps stepping with zeros until the
    other is done. Every row trains once, on one rank, and every loss is
    finite."""
    from ray_tpu_torch.examples import batch_inference as bi
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    fresh_init(ray_tpu_torch, num_cpus=4)
    rows = {0: 0, 1: 0}
    losses = []

    def probe(event, rank, step, **info):
        if event == "step":
            rows[rank] += B
            losses.append(info["loss"])

    try:
        ds = bi.token_dataset(bi.token_windows(
            48, train_gpt2.TINY["seq_len"], train_gpt2.TINY["vocab_size"]), 3)
        trainer = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=dict(batch_size=B, tiny=True, device="cpu",
                                   init_params=init, lr=LR, probe=probe),
            scaling_config=ScalingConfig(num_workers=W, use_gpu=False),
            run_config=RunConfig(storage_path=tempfile.mkdtemp()),
            datasets={"train": ds})
        result = bounded(trainer.fit, CASE_S)
        audit = trainer.streaming_ingests["train"].audit(0)
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    assert audit["double_trained"] == [] and audit["untrained"] == []
    assert sorted(audit["trained_counts"].values()) == [1, 1, 1]
    # 3 blocks of 16 rows over 2 ranks: never an even split.
    assert sum(rows.values()) == 48 and rows[0] != rows[1]
    assert np.isfinite(losses).all()


def test_async_checkpoints_resume_from_memory(init, tokens):
    """Two ranks save asynchronously (``CheckpointConfig(async_save=True)``,
    every rank its shard, every 2 steps), fail after step 3 of the first
    attempt and resume: the restart restores the coordinator's newest
    committed step from the memory replicas, bit for bit, and every step's
    loss is within TOL of an uninterrupted async run's. Rank 0 reports step
    3 half a second late, after rank 1 has failed: a report a rank makes of
    a step it finished before it stops is kept, as the reference's failure
    path means to ("keep results reported before the crash"), so step 3 is
    in the history every time. A run whose every save fails finishes with
    ``result.error`` saying so."""
    from ray_tpu_torch._private import fault_injection
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.checkpoint import layout
    from ray_tpu_torch.checkpoint import metrics as ckpt_metrics
    from ray_tpu_torch.optim import tree_leaves
    from ray_tpu_torch.train import (
        CheckpointConfig,
        CudaTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )

    def memory_restores():
        return ckpt_metrics.RESTORES.get(tags={"source": "memory"})

    def fit(late_step=None, **extra):
        seen = {"restore": [], "checkpoint": {}}

        def probe(event, rank, step, **info):
            if event == "step" and rank == 0 and step == late_step \
                    and not seen["restore"]:
                time.sleep(0.5)  # rank 1 fails before this report
            if event in ("restore", "checkpoint") and rank == 0:
                state = info["state"]
                leaves = [t.detach().clone() for t in
                          tree_leaves(state["params"]) +
                          tree_leaves(state["opt_state"]["mu"]) +
                          tree_leaves(state["opt_state"]["nu"])]
                if event == "restore":
                    seen["restore"].append((step, leaves))
                else:
                    seen["checkpoint"][step] = leaves

        storage = tempfile.mkdtemp()
        config = dict(steps=6, batch_size=B, tiny=True, device="cpu",
                      init_params=init, tokens=tokens, lr=LR, ckpt_every=2,
                      async_save=True, probe=probe)
        config.update(extra)
        result = CudaTrainer(
            train_gpt2.train_loop_per_worker, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=W, use_gpu=False),
            run_config=RunConfig(
                name="async", storage_path=storage,
                checkpoint_config=CheckpointConfig(num_to_keep=2,
                                                   async_save=True),
                failure_config=FailureConfig(max_failures=1))).fit()
        root = os.path.join(storage, "async", "checkpoints", "sharded")
        return result, seen, layout.list_committed_steps(root)

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        before = memory_restores()
        broken, seen, committed = bounded(
            lambda: fit(fail_at_step=3, late_step=3), CASE_S)
        restored_from_memory = memory_restores() - before
        whole, _, _ = bounded(fit, CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert broken.error is None and len(broken.restarts) == 1
    restore = broken.restarts[0]["restore"]
    assert restore["source"] == "memory" and restored_from_memory == 1
    (restored_step, restored), = seen["restore"]
    assert restored_step == 2 * (restore["step"] + 1)
    for a, b in zip(restored, seen["checkpoint"][restored_step]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(a.dtype == torch.bfloat16 for a in restored)
    want = {m["step"]: m["loss"] for m in whole.metrics_history}
    got = [(m["step"], m["loss"]) for m in broken.metrics_history]
    assert [s for s, _ in got] == [1, 2, 3] + list(
        range(restored_step + 1, 7))
    assert all(abs(loss - want[step]) <= TOL for step, loss in got), \
        (got, want)
    assert len(committed) == 2
    assert int(broken.checkpoint.to_pytree()["step"]) == 6

    GLOBAL_CONFIG.testing_rpc_failure = "ckpt_shard_write=1:1000"
    fault_injection.reset_injector()
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        failed, _, committed = bounded(lambda: fit(steps=2), CASE_S)
    finally:
        GLOBAL_CONFIG.testing_rpc_failure = ""
        fault_injection.reset_injector()
        ray_tpu_torch.shutdown()
    assert [m["step"] for m in failed.metrics_history] == [1, 2]
    assert "no step ever committed" in str(failed.error)
    assert committed == [] and failed.checkpoint is None
