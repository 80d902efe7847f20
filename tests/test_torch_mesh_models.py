"""Llama, ViT and MoE on the port's device mesh against the JAX package's
(``tests/test_llama.py:85``, ``tests/test_vit.py:84`` and ``:111``,
``tests/test_pipeline.py:131`` and ``:161``), with the gates of
``tests/test_torch_mesh.py``: in fp32, the loss within 1e-5, every gradient
within 1e-5 of the leaf's largest entry, one AdamW update from the same
gradients within 1e-5, and each rank's shards those of the reference's
device of the same index. MoE runs with its experts sharded over
``expert`` and is also held to the replicated forward.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_mesh_cases as cases
from _torch_mesh import world
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import vit as tvit
from test_torch_mesh import DP_FSDP_TP, TOL, _tokens, assert_step_matches


def _kw(config):
    return {f.name: getattr(config, f.name)
            for f in dataclasses.fields(config)}


def test_llama_step_dp_fsdp_tp_matches_reference():
    """GQA (kv heads on ``tensor`` beside their query heads) and RoPE on
    each rank's heads, through the reference's logical-axis rules."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               logits_dtype=jnp.float32, attn_impl="xla")
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32,
                               logits_dtype=torch.float32, attn_impl="splash")
    assert tcfg.n_kv_head < tcfg.n_head and tcfg.n_kv_head % 2 == 0
    params = jllama.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(jcfg.vocab_size, 8, jcfg.seq_len)
    assert_step_matches("llama", _kw(tcfg), jllama, jcfg, params,
                        jnp.asarray(x), jnp.asarray(y), DP_FSDP_TP,
                        jllama.make_optimizer(1e-3),
                        {"learning_rate": 1e-3})


def _vit_batch(config, b):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(b, config.image_size, config.image_size,
                              3)).astype(np.float32)
    return images, rng.integers(0, config.num_classes, b).astype(np.int32)


def test_vit_step_dp_fsdp_tp_matches_reference():
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tvit.ViTConfig.tiny(), dtype=torch.float32)
    params = jvit.init_params(jcfg, jax.random.key(0))
    images, labels = _vit_batch(jcfg, 8)
    assert_step_matches("vit", _kw(tcfg), jvit, jcfg, params,
                        jnp.asarray(images), jnp.asarray(labels), DP_FSDP_TP,
                        jvit.make_optimizer(1e-3),
                        {"learning_rate": 1e-3, "weight_decay": 0.05,
                         "b2": 0.999, "grad_clip": math.inf,
                         "mu_dtype": torch.float32})


def test_vit_sharded_matches_single_device():
    """``tests/test_vit.py:111``: on ``MeshSpec(data=4, tensor=2)`` the
    port's loss equals the reference's single-device loss."""
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tvit.ViTConfig.tiny(), dtype=torch.float32)
    params = jvit.init_params(jcfg, jax.random.key(0))
    images, labels = _vit_batch(jcfg, 4)
    want = float(jvit.loss_fn(params, jnp.asarray(images),
                              jnp.asarray(labels), jcfg))
    out = world(8).run(cases.model_step, "vit", {"data": 4, "tensor": 2},
                       _kw(tcfg), jax.tree.map(np.asarray, params), images,
                       labels)
    assert abs(out[0]["loss"] - want) <= TOL


MOE = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
           n_experts=4, expert_mlp=128, attn_impl="xla")


def test_moe_step_expert_parallel_matches_reference():
    """``tests/test_pipeline.py:131``: the experts' leading axis sharded over
    ``expert=4`` beside ``data=2``, routed over the global batch."""
    jcfg = jmoe.MoEConfig(**MOE, dtype=jnp.float32)
    params = jmoe.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(256, 8, 32)
    assert_step_matches("moe", dict(MOE, dtype=torch.float32), jmoe, jcfg,
                        params, jnp.asarray(x), jnp.asarray(y),
                        {"data": 2, "expert": 4},
                        jgpt2.make_optimizer(1e-3, mu_dtype=jnp.float32),
                        {"learning_rate": 1e-3, "mu_dtype": torch.float32})


def test_moe_expert_parallel_matches_replicated():
    """``tests/test_pipeline.py:161``: the same weights give the same logits
    and aux loss with the experts sharded as replicated, and as the
    reference's forward; three train steps lower the loss."""
    cfg = dict(MOE, vocab_size=128, d_model=32, seq_len=16, n_head=2,
               expert_mlp=64, remat=False)
    jcfg = jmoe.MoEConfig(**cfg, dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jmoe.init_params(jcfg, jax.random.key(0)))
    tokens = np.random.default_rng(1).integers(0, 128, (4, 16)).astype(
        np.int32)
    want, want_aux = jmoe.forward(params, jnp.asarray(tokens), jcfg)
    tcfg = dict(cfg, dtype=torch.float32)
    w = world(8)
    out = w.run(cases.moe_forward, {"expert": 4, "data": 2}, tcfg, params,
                tokens)
    for rank in out:
        # Mesh dimensions (data, expert): (L, E, D, F) split on E.
        assert rank["expert_in_w"] == ["Replicate()", "Shard(dim=1)"]
        assert rank["local"][1] == 1  # one of the four experts per rank
        np.testing.assert_allclose(rank["logits"], rank["want"], rtol=0,
                                   atol=2e-5)
        assert abs(rank["aux"] - rank["want_aux"]) <= 1e-5
    np.testing.assert_allclose(out[0]["logits"], np.asarray(want), rtol=0,
                               atol=1e-4)
    assert abs(out[0]["aux"] - float(want_aux)) <= 1e-5
    x, y = tokens, np.roll(tokens, -1, axis=1)
    losses, finals = zip(*w.run(
        cases.train_losses, "moe", {"expert": 4, "data": 2}, tcfg, params,
        x, y, 3, {"learning_rate": 1e-2, "weight_decay": 0.0,
                  "grad_clip": math.inf, "mu_dtype": torch.float32}))
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]
    assert all(ls == losses[0] for ls in losses)
    for other in finals[1:]:
        for a, b in zip(finals[0], other):
            np.testing.assert_array_equal(a, b)
