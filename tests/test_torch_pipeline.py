"""The port's pipeline parallelism (``ray_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``tests/test_pipeline.py:21-110``).

JAX runs ``pipeline_apply`` under ``shard_map`` on the 8-device CPU mesh of
tests/conftest.py; the port runs it on a mesh whose ``pipe`` axis spans
gloo processes of a ``_torch_mesh`` world (the rank side is
``_torch_cp_cases``), each stage a rank with its slice of the layers, the
other axes DTensor dimensions inside a stage. Weights and inputs are the
same numpy arrays on both sides; tolerances are
tests/test_torch_ring_attention.py's and tests/test_torch_mesh.py's, in
fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_cases as cases
import _torch_mesh_cases as mesh_cases
from _torch_mesh import world
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from test_torch_mesh import _tokens, assert_step_matches
from test_torch_ring_attention import FWD_TOL, GRAD_ATOL, GRAD_RTOL

PIPE_DATA = {"pipe": 4, "data": 2}
PDT = {"pipe": 2, "data": 2, "tensor": 2}
GPT_PP = dict(vocab_size=512, n_layer=4, n_head=4, d_model=64, seq_len=32)


def _stack(local_w, h):
    """``tests/test_pipeline.py``'s stage function: a scan of tanh layers."""
    def body(c, wi):
        return jnp.tanh(c @ wi), None

    h, _ = jax.lax.scan(body, h, local_w)
    return h


def test_pipeline_matches_sequential():
    """``pipeline_apply`` over ``(pipe=4, data=2)`` equals applying every
    layer in turn; each rank holds its two of the eight layers and the
    output comes back replicated over ``pipe``."""
    L, D = 8, 16
    w = np.asarray(jax.random.normal(jax.random.key(0), (L, D, D)) * 0.1)
    x = np.asarray(jax.random.normal(jax.random.key(1), (8, D)))
    want = np.asarray(_stack(jnp.asarray(w), jnp.asarray(x)))
    out = world(8).run(cases.pipeline, PIPE_DATA, w, x, 4)
    for rank in out:
        assert rank["local_layers"] == 2
        assert rank["placements"] == ["Replicate()", "Shard(dim=0)"]
        np.testing.assert_allclose(rank["out"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_pipeline_gradients_match():
    """The layers' gradient through the schedule's backward (the inverse
    shifts, stage by stage) equals the sequential stack's."""
    L, D = 4, 8
    w = np.asarray(jax.random.normal(jax.random.key(0), (L, D, D)) * 0.1)
    x = np.asarray(jax.random.normal(jax.random.key(1), (4, D)))
    want = np.asarray(jax.grad(lambda w: jnp.sum(
        _stack(w, jnp.asarray(x)) ** 2))(jnp.asarray(w)))
    out = world(8).run(cases.pipeline, PIPE_DATA, w, x, 2, True)
    for rank in out:
        np.testing.assert_allclose(rank["grad"], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def _gpt_kw(config, **kw):
    return {f: getattr(config, f) for f in (
        "vocab_size", "n_layer", "n_head", "d_model", "seq_len", "remat",
        "attn_impl", "pp_stages", "pp_microbatches")} | kw


def test_gpt2_pipelined_forward_matches_unpipelined():
    """``test_gpt2_pipelined_forward_matches_unpipelined``: two stages of
    two layers over ``(pipe=2, data=2, tensor=2)``, two microbatches, give
    the reference's unpipelined logits."""
    base = jgpt2.GPTConfig(**GPT_PP, dtype=jnp.float32, remat=False,
                           attn_impl="xla")
    params = jgpt2.init_params(base, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(
        np.int32)
    want = np.asarray(jgpt2.forward(params, jnp.asarray(tokens), base))
    pp = dict(_gpt_kw(base, pp_stages=2, pp_microbatches=2),
              dtype=torch.float32)
    out = world(8).run(cases.gpt2_forward, PDT, pp,
                       jax.tree.map(np.asarray, params), tokens)
    for rank in out:
        np.testing.assert_allclose(rank, want, rtol=0,
                                   atol=FWD_TOL * np.abs(want).max())


def test_gpt2_pipelined_train_step_matches_reference():
    """``test_gpt2_pipelined_train_step`` on ``(pipe=2, data=2, tensor=2)``:
    the port's loss, every synced gradient (each stage's blocks and the
    replicated embedding and head) and one AdamW update against the
    reference's pipelined step on its mesh; each rank holds the reference's
    shard of every leaf."""
    jcfg = jgpt2.GPTConfig(**dict(GPT_PP, vocab_size=256), dtype=jnp.float32,
                           attn_impl="xla", pp_stages=2, pp_microbatches=2,
                           logits_dtype=jnp.float32)
    tcfg = dict(_gpt_kw(jcfg), dtype=torch.float32,
                logits_dtype=torch.float32)
    params = jgpt2.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(256, 4, 32)
    assert_step_matches("gpt2", tcfg, jgpt2, jcfg, params, jnp.asarray(x),
                        jnp.asarray(y), PDT,
                        jgpt2.make_optimizer(1e-3, mu_dtype=jnp.float32),
                        {"learning_rate": 1e-3, "mu_dtype": torch.float32},
                        ambient=True)


def test_gpt2_pipelined_training_lowers_the_loss():
    """``test_gpt2_pipelined_train_step``'s check: five steps of the
    pipelined dp+pp+tp step lower the loss, and every rank ends with the
    same replicas of what it shares."""
    cfg = dict(GPT_PP, vocab_size=256, dtype=torch.float32, attn_impl="xla",
               pp_stages=2, pp_microbatches=2)
    jcfg = jgpt2.GPTConfig(**dict(cfg, dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jgpt2.init_params(jcfg,
                                                        jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, 256, (4, 32)).astype(
        np.int32)
    losses, finals = zip(*world(8).run(
        mesh_cases.train_losses, "gpt2", PDT, cfg, params, tokens,
        np.roll(tokens, -1, axis=1), 5,
        {"learning_rate": 1e-2, "mu_dtype": torch.float32}))
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]
    assert all(ls == losses[0] for ls in losses)
    for other in finals[1:]:
        for a, b in zip(finals[0], other):
            np.testing.assert_array_equal(a, b)


def test_create_sharded_state_slices_the_layers_over_pipe():
    """``create_sharded_state`` keeps each stage's contiguous slice of the
    stacked layers, bit for bit ``init_params``'s."""
    out = world(8).run(mesh_cases.sharded_state, "gpt2", PDT,
                       dict(GPT_PP, pp_stages=2), 3)
    for rank in out:
        assert all(rank["same"]) and all(rank["placed"])


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,match", [
    (dict(remat=True, remat_policy="attn_outside", attn_impl="splash"),
     "attn_outside"),
    (dict(n_layer=3), "n_layer 3 % pp_stages 2")])
def test_pipelined_config_refusals_are_the_references(kw, match):
    """The reference's refusals of a pipelined config: the attention outside
    the remat regions, and layers that do not divide into the stages."""
    cfg = dict(GPT_PP, pp_stages=2, **kw)
    jkw = dict(cfg, attn_impl="pallas") if "attn_outside" in match else cfg
    jcfg = jgpt2.GPTConfig(**jkw, dtype=jnp.float32)
    tcfg = tgpt2.GPTConfig(**cfg, dtype=torch.float32)
    jparams = jgpt2.init_params(jcfg, jax.random.key(0))
    tparams = tgpt2.init_params(tcfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        jgpt2.forward(jparams, jnp.zeros((2, 32), jnp.int32), jcfg)
    with pytest.raises(ValueError, match=match):
        tgpt2.forward(tparams, torch.zeros((2, 32), dtype=torch.long), tcfg)


def test_pipe_axis_that_disagrees_with_the_config_is_refused():
    """``pp_stages=2`` on a mesh whose ``pipe`` axis is 4: the reference's
    ValueError, on every rank."""
    cfg = dict(GPT_PP, pp_stages=2, dtype=torch.float32, attn_impl="xla")
    jcfg = jgpt2.GPTConfig(**dict(cfg, dtype=jnp.float32))
    params = jax.tree.map(np.asarray, jgpt2.init_params(jcfg,
                                                        jax.random.key(0)))
    out = world(8).run(cases.gpt2_refusal, PIPE_DATA, cfg, params,
                       np.zeros((4, 32), np.int32))
    assert all("config.pp_stages=2 but mesh pipe axis is 4" in r
               for r in out), out


# ----------------------------------------------------- the Trainer's mesh mode
@pytest.mark.parametrize("spec,extra", [
    ({"seq": 2}, {"attn_impl": "ring"}),
    ({"pipe": 2}, {"attn_impl": "xla", "pp_stages": 2,
                   "pp_microbatches": 2})], ids=["seq", "pipe"])
def test_trainer_mesh_mode_runs_seq_and_pipe_meshes(tmp_path, spec, extra):
    """The Trainer's mesh mode (``ScalingConfig(backend="gloo")``) with a
    mesh whose ``seq`` or ``pipe`` axis spans its two process ranks: each
    rank feeds its block of the batch (``local_batch_to_global`` over
    ``batch_sharding``), and the losses of two steps are one process's on
    the whole batch with the same weights (fp32, within 1e-5)."""
    import ray_tpu_torch
    from _torch_runtimes import fresh_init
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    cfg = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
               dtype=torch.float32, logits_dtype=torch.float32, remat=False)
    x, y = _tokens(256, 4, 32)
    jparams = jax.tree.map(np.asarray, jgpt2.init_params(
        jgpt2.GPTConfig(**dict(cfg, dtype=jnp.float32,
                               logits_dtype=jnp.float32)),
        jax.random.key(0)))

    def loop(config):
        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.collective import distributed
        from ray_tpu_torch.models import convert, gpt2
        from ray_tpu_torch.parallel import (MeshSpec, batch_sharding,
                                            make_mesh, shard_pytree)
        from ray_tpu_torch.parallel.mesh import axis_index

        torch.set_num_threads(1)
        c = gpt2.GPTConfig(**config["cfg"])
        mesh = make_mesh(MeshSpec(**config["spec"]), device="cpu")
        params = shard_pytree(
            convert.params_from_numpy(config["params"], device="cpu"),
            gpt2.logical_axes(c), mesh)
        opt = gpt2.make_optimizer(1e-3)
        state = opt.init(params)
        j, s = axis_index(mesh, "seq"), 32 // mesh.shape["seq"]
        xs, ys = (distributed.local_batch_to_global(
            mesh, np.asarray(a)[:, j * s:(j + 1) * s],
            axis=batch_sharding(mesh).spec) for a in (config["x"],
                                                      config["y"]))
        step = gpt2.make_train_step(c, opt)
        for _ in range(2):
            params, state, loss = step(params, state, xs, ys)
            train.report({"loss": float(loss),
                          "backend": dist.get_backend()})

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        trainer = CudaTrainer(
            loop, train_loop_config={"cfg": dict(cfg, **extra),
                                     "params": jparams, "x": x, "y": y,
                                     "spec": spec},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                         worker_mode="processes",
                                         backend="gloo"),
            run_config=RunConfig(name="mesh", storage_path=str(tmp_path)))
        res = trainer.fit()
    finally:
        ray_tpu_torch.shutdown()
    assert res.error is None, res.error
    hist = res.metrics_history
    assert len(hist) == 2 and all(m["backend"] == "gloo" for m in hist)
    c = tgpt2.GPTConfig(**dict(cfg, attn_impl="xla"))
    params = convert.params_from_numpy(jparams, device="cpu")
    opt = tgpt2.make_optimizer(1e-3)
    state = opt.init(params)
    step = tgpt2.make_train_step(c, opt)
    for m in hist:
        params, state, loss = step(params, state, torch.as_tensor(x),
                                   torch.as_tensor(y))
        assert abs(m["loss"] - float(loss)) <= 1e-5
