"""The port's device mesh against the JAX package's (``tests/test_models.py``
:65, :88, :115 and ``tests/test_collective.py:177``).

The JAX side runs on the reference's 8-device CPU mesh (tests/conftest.py);
the port's side runs in a world of gloo processes on the CPU
(``_torch_mesh``), whose ranks import torch and the port and never JAX. The
weights are the JAX package's, carried across by ``models.convert``. In
fp32, the port's step on ``MeshSpec(data=2, fsdp=2, tensor=2)`` gives the
reference's loss within 1e-5, every gradient (gathered with
``full_tensor()``) within 1e-5 of the leaf's largest entry, the same AdamW
update from the same gradients within 1e-5, and every rank holds the shard
of each leaf that the reference's device of the same index holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_mesh_cases as cases
from _torch_mesh import world
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import mesh as tmesh

TOL = 1e-5
DP_FSDP_TP = {"data": 2, "fsdp": 2, "tensor": 2}
GPT = dict(vocab_size=512, n_layer=2, n_head=4, d_model=128, seq_len=64)


def leaves(tree, order):
    """numpy leaves of ``tree`` (a JAX dict tree, whose keys come back
    sorted) in the key order of ``order`` (the models' logical axes)."""
    if isinstance(order, dict):
        return [x for k in order for x in leaves(tree[k], order[k])]
    return [np.asarray(tree, np.float32)]


def jax_step(jmod, jcfg, params, inputs, targets, spec, opt=None,
             ambient=False):
    """loss, gradients, and (given an optax optimizer) the parameters after
    one update, jitted over the reference's mesh, and the sharded params.
    ``ambient`` installs the mesh (``set_mesh``) around the step, as
    ``jit_train_step(mesh=)`` does, for the paths that read it (ring and
    Ulysses attention, the pipeline)."""
    if ambient:
        from ray_tpu._private.jax_compat import set_mesh

        with set_mesh(jmesh.make_mesh(jmesh.MeshSpec(**spec))):
            return jax_step(jmod, jcfg, params, inputs, targets, spec, opt)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(**spec))
    sharded = jax.device_put(
        params, jmesh.pytree_sharding(jmod.logical_axes(jcfg), mesh))
    sh = jmesh.batch_sharding(mesh)
    x = jax.device_put(inputs, NamedSharding(mesh, JP(*sh.spec[:inputs.ndim])))
    y = jax.device_put(targets,
                       NamedSharding(mesh, JP(*sh.spec[:targets.ndim])))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, x, y: jmod.loss_fn(p, x, y, jcfg)))(sharded, x, y)
    updated = None
    if opt is not None:
        updates, _ = opt.update(grads, opt.init(sharded), sharded)
        updated = optax.apply_updates(sharded, updates)
    return float(loss), grads, updated, sharded


def assert_step_matches(name, tcfg_kw, jmod, jcfg, params, inputs, targets,
                        spec, jopt, opt_kw, ambient=False):
    """The port's step on the mesh against the reference's, as the module
    docstring says; the gradients each rank holds before their
    redistribution must fail the gradient gate (a control)."""
    loss, grads, updated, sharded = jax_step(jmod, jcfg, params, inputs,
                                             targets, spec, jopt, ambient)
    np_params = jax.tree.map(np.asarray, params)
    np_grads = jax.tree.map(np.asarray, grads)
    out = world(int(np.prod(list(spec.values())))).run(
        cases.model_step, name, spec, tcfg_kw, np_params, np.asarray(inputs),
        np.asarray(targets), np_grads, opt_kw)
    got = out[0]
    assert abs(got["loss"] - loss) <= TOL * max(1.0, abs(loss)), \
        (got["loss"], loss)
    order = jmod.logical_axes(jcfg)
    want = leaves(np_grads, order)
    for g, w in zip(got["grads"], want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    assert any(o.shape != w.shape
               or np.abs(o - w).max() > TOL * np.abs(w).max()
               for o, w in zip(got["own"], want)), "the control passed"
    for p, w in zip(got["updated"], leaves(jax.tree.map(np.asarray, updated),
                                           order)):
        assert np.abs(p - w).max() <= TOL * np.abs(w).max()
    # Every rank holds the reference's shard of each leaf on its device.
    devices = jax.devices()
    for rank, placed in enumerate([got["placed"]] + out[1:]):
        for (shape, _), x, axes in zip(
                placed, _ordered(sharded, order),
                cases._logical_leaves(order)):
            want_shape = next(s.data.shape for s in x.addressable_shards
                              if s.device == devices[rank])
            assert shape == tuple(want_shape), (rank, axes)
    for (_, pl), (_, mpl) in zip(got["placed"], got["mu_placed"]):
        assert pl == mpl


def _ordered(tree, order):
    if isinstance(order, dict):
        return [x for k in order for x in _ordered(tree[k], order[k])]
    return [tree]


def _tokens(vocab, b, s, seed=0):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)


# ---------------------------------------------------------------- the rules
@pytest.mark.parametrize("tmod,jmod,cfg", [
    (tgpt2, jgpt2, "GPTConfig"), (tllama, jllama, "LlamaConfig"),
    (tvit, jvit, "ViTConfig"), (tmoe, jmoe, "MoEConfig")],
    ids=["gpt2", "llama", "vit", "moe"])
def test_logical_axes_and_specs_are_the_references(tmod, jmod, cfg):
    tcfg, jcfg = getattr(tmod, cfg).tiny(), getattr(jmod, cfg).tiny()
    assert tmod.logical_axes(tcfg) == jmod.logical_axes(jcfg)
    for axes in cases._logical_leaves(tmod.logical_axes(tcfg)):
        assert tuple(tmesh.logical_to_spec(axes)) == \
            tuple(jmesh.logical_to_spec(axes))
    assert tmesh.DEFAULT_RULES == jmesh.DEFAULT_RULES
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES


def test_mesh_spec_validation():
    """``tests/test_models.py:115``: a mesh larger than the process group is
    refused, and ``MeshSpec.auto`` fills the data axis."""
    with pytest.raises(ValueError, match="process group has 1"):
        tmesh.make_mesh(tmesh.MeshSpec(data=100))
    spec = tmesh.MeshSpec.auto(8, tensor=2)
    assert spec.data == 4 and spec.size == 8
    assert dataclasses.asdict(spec) == \
        dataclasses.asdict(jmesh.MeshSpec.auto(8, tensor=2))


def test_placements_follow_the_rules():
    class FakeMesh:
        dim_names = ("data", "fsdp", "tensor")

    from torch.distributed.tensor import Replicate, Shard

    got = tmesh.logical_to_placements(("layers", "embed", "heads"),
                                      FakeMesh())
    assert got == [Replicate(), Shard(1), Shard(2)]
    assert tmesh.logical_to_placements(("batch", "seqlen"), FakeMesh()) == \
        [Shard(0), Shard(0), Replicate()]


# ----------------------------------------------------------------- GPT-2
@pytest.mark.parametrize("attn,loss_impl", [("xla", "dense"),
                                            ("splash", "fused")])
def test_gpt2_step_dp_fsdp_tp_matches_reference(attn, loss_impl):
    """``tests/test_models.py:65`` in fp32, held to the reference's step."""
    jcfg = jgpt2.GPTConfig(**GPT, dtype=jnp.float32, attn_impl="xla",
                           logits_dtype=jnp.float32)
    tcfg = dict(GPT, dtype=torch.float32, attn_impl=attn, loss_impl=loss_impl,
                logits_dtype=torch.float32)
    params = jgpt2.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(512, 8, 64)
    assert_step_matches("gpt2", tcfg, jgpt2, jcfg, params, jnp.asarray(x),
                        jnp.asarray(y), DP_FSDP_TP,
                        jgpt2.make_optimizer(1e-3, mu_dtype=jnp.float32),
                        {"learning_rate": 1e-3, "mu_dtype": torch.float32})


def test_gpt2_sharded_matches_single_device():
    """``tests/test_models.py:88``: on ``MeshSpec(data=4, tensor=2)`` the
    port's loss equals the reference's single-device loss (fp32)."""
    cfg = dict(vocab_size=256, n_layer=1, n_head=2, d_model=64, seq_len=32,
               remat=False, attn_impl="xla")
    jcfg = jgpt2.GPTConfig(**cfg, dtype=jnp.float32, logits_dtype=jnp.float32)
    params = jgpt2.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(256, 4, 32)
    want = float(jgpt2.loss_fn(params, jnp.asarray(x), jnp.asarray(y), jcfg))
    out = world(8).run(
        cases.model_step, "gpt2", {"data": 4, "tensor": 2},
        dict(cfg, dtype=torch.float32, logits_dtype=torch.float32),
        jax.tree.map(np.asarray, params), x, y)
    assert abs(out[0]["loss"] - want) <= TOL


@pytest.mark.parametrize("name", ["gpt2", "llama", "vit", "moe"])
def test_create_sharded_state_is_init_params_sharded(name):
    """Each rank's shard of every leaf is bit for bit its slice of the
    single-process ``init_params(config, seed)``, placed as the rules say;
    the moments are sharded like their parameters."""
    cfg = {"gpt2": GPT, "llama": {}, "vit": {}, "moe": {}}[name]
    if name != "gpt2":
        mod = {"llama": tllama, "vit": tvit, "moe": tmoe}[name]
        cfg = {f.name: getattr(cfg_obj, f.name) for cfg_obj in
               [getattr(mod, {"llama": "LlamaConfig", "vit": "ViTConfig",
                              "moe": "MoEConfig"}[name]).tiny()]
               for f in dataclasses.fields(cfg_obj)}
    spec = {"expert": 2, "data": 2} if name == "moe" else \
        {"fsdp": 2, "tensor": 2}
    out = world(4).run(cases.sharded_state, name, spec, cfg, 3)
    for rank in out:
        assert all(rank["same"]) and all(rank["placed"])
        assert all(ok for _, ok in rank["mu"])
        assert {dt for dt, _ in rank["mu"]} == {"torch.bfloat16"}


def test_no_dtensor_reaches_a_kernel():
    """The splash and fused-CE wrappers refuse DTensors (a kernel reads raw
    pointers); the models call them under ``shard_map``, which hands each
    rank its local tensors and gives a DTensor back."""
    out = world(4).run(cases.kernels_refuse_dtensors, {"data": 4})
    for splash, ce, (shape, placement) in out:
        assert "shard_map" in splash and "shard_map" in ce
        assert shape == (4, 8, 2, 16) and placement == "Shard(dim=0)"


# ------------------------------------------------- batches and collectives
def test_local_batch_to_global():
    """Each rank's rows become its shard of one global batch over
    ``data`` (the reference's multihost input pipeline primitive)."""
    out = world(4).run(cases.local_batch_to_global, {"data": 2, "tensor": 2},
                       3, 2)
    base = np.arange(6, dtype=np.float32).reshape(3, 2)
    for rank in out:
        assert rank["shape"] == (6, 2)
        assert rank["placements"] == ["Shard(dim=0)", "Replicate()"]
    # Ranks 0 and 1 share data index 0, ranks 2 and 3 index 1.
    np.testing.assert_array_equal(out[0]["full"],
                                  np.concatenate([base, base + 2000]))


def test_local_batch_to_global_over_the_batch_axes():
    """``axis`` as a PartitionSpec entry: the batch's ``("data", "fsdp")``
    on an fsdp x tensor mesh (``data`` is no dimension there) shards the
    rows over ``fsdp`` and replicates them over ``tensor``."""
    out = world(4).run(cases.local_batch_to_global, {"fsdp": 2, "tensor": 2},
                       3, 2, ("data", "fsdp"))
    base = np.arange(6, dtype=np.float32).reshape(3, 2)
    for rank in out:
        assert rank["shape"] == (6, 2)
        assert rank["placements"] == ["Shard(dim=0)", "Replicate()"]
    np.testing.assert_array_equal(out[0]["full"],
                                  np.concatenate([base, base + 2000]))


def test_profiled_step_times_the_gradient_sync_alone():
    """Under an active step profiler the step waits for its backward and
    for every rank before the gradient sync, so the ``collective`` bucket
    holds the sync alone; the waits change no loss and no parameter."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, GPT["vocab_size"], (4, GPT["seq_len"] + 1))
    out = world(4).run(cases.profiled_step, {"data": 2, "fsdp": 2},
                       dict(GPT, dtype=torch.float32), tokens)
    for rank in out:
        assert rank["same"]
        row = rank["row"]
        assert 0.0 < row["collective"] <= row["wall"]


def test_collectives_ride_the_mesh():
    """``tests/test_collective.py:177``: every redistribution of a DTensor
    on the mesh is the collective it names, with its values."""
    n = 4
    out = world(n).run(cases.collectives_on_mesh, {"data": 2, "fsdp": 2})
    total = np.arange(2 * n, dtype=np.float32) * sum(range(1, n + 1))
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["all_reduce"], total)
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            got["all_gather"], np.repeat(np.arange(n, dtype=np.float32), 2))
        np.testing.assert_array_equal(got["scatter"], np.zeros(2))


# ----------------------------------------------------- the Trainer's mesh mode
def test_trainer_mesh_mode_over_gloo(tmp_path):
    """The Trainer's mesh mode (the reference's ``JaxTrainer`` docstring,
    ray_tpu/train/trainer.py:1180-1189): two process ranks, joined over a
    gloo the caller asks for (``ScalingConfig(backend="gloo")``), build a
    data mesh over their group inside ``train_loop_per_worker`` and train
    GPT-2 on DTensors; their losses are one process's on the whole batch
    (fp32, within 1e-5), and both ranks end with the same weights."""
    import ray_tpu_torch
    from _torch_runtimes import fresh_init
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    cfg = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
               attn_impl="xla", dtype=torch.float32,
               logits_dtype=torch.float32)
    x, y = _tokens(256, 4, 32)
    jparams = jax.tree.map(np.asarray, jgpt2.init_params(
        jgpt2.GPTConfig(**dict(cfg, dtype=jnp.float32,
                               logits_dtype=jnp.float32)),
        jax.random.key(0)))

    def loop(config):
        import hashlib

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.models import convert, gpt2
        from ray_tpu_torch.optim import tree_leaves
        from ray_tpu_torch.parallel import (MeshSpec, batch_sharding,
                                            make_mesh, shard_pytree)
        from ray_tpu_torch.parallel.mesh import distribute

        torch.set_num_threads(1)
        c = gpt2.GPTConfig(**config["cfg"])
        mesh = make_mesh(MeshSpec(data=2), device="cpu")
        params = shard_pytree(
            convert.params_from_numpy(config["params"], device="cpu"),
            gpt2.logical_axes(c), mesh)
        opt = gpt2.make_optimizer(1e-3)
        state = opt.init(params)
        sh = batch_sharding(mesh).placements
        xs, ys = (distribute(torch.as_tensor(a), mesh, sh)
                  for a in (config["x"], config["y"]))
        step = gpt2.make_train_step(c, opt)
        for _ in range(2):
            params, state, loss = step(params, state, xs, ys)
            digest = hashlib.sha256(b"".join(
                p.to_local().detach().numpy().tobytes()
                for p in tree_leaves(params))).hexdigest()
            digests = [None] * dist.get_world_size()
            dist.all_gather_object(digests, digest)
            train.report({"loss": float(loss), "backend": dist.get_backend(),
                          "same": len(set(digests)) == 1})

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        trainer = CudaTrainer(
            loop, train_loop_config={"cfg": cfg, "params": jparams, "x": x,
                                     "y": y},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                         worker_mode="processes",
                                         backend="gloo"),
            run_config=RunConfig(name="mesh", storage_path=str(tmp_path)))
        res = trainer.fit()
    finally:
        ray_tpu_torch.shutdown()
    assert res.error is None, res.error
    assert [r["backend"] for r in trainer.process_topology] == ["gloo"] * 2
    hist = res.metrics_history
    assert all(m["backend"] == "gloo" and m["same"] for m in hist)
    c = tgpt2.GPTConfig(**cfg)
    params = convert.params_from_numpy(jparams, device="cpu")
    opt = tgpt2.make_optimizer(1e-3)
    state = opt.init(params)
    step = tgpt2.make_train_step(c, opt)
    for m in hist:
        params, state, loss = step(params, state, torch.as_tensor(x),
                                   torch.as_tensor(y))
        assert abs(m["loss"] - float(loss)) <= TOL
