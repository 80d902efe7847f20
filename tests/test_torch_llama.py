"""The port's Llama (ray_tpu_torch.models.llama) against the JAX package's,
case by case with tests/test_llama.py, then the JAX functions themselves.

Both sides get the same parameters (JAX's init, as numpy, through the
converter) and the same tokens (numpy, from a seed) at ``LlamaConfig.tiny()``
(2 layers, D=128, 4 query heads over 2 kv heads of 32, d_ff 384, S=128,
V=1024) in fp32 unless a case says otherwise. JAX's splash attention runs
its Pallas kernel in interpret mode on the CPU, the port's the plain
version, and JAX's ring runs on the 8-device CPU mesh of tests/conftest.py
while the port folds the seq axis onto the CPU. The sharded dp/fsdp/tp step
of tests/test_llama.py waits for the data, fsdp and tensor axes (ROADMAP.md,
Queue 1 item 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private.jax_compat import set_mesh
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu_torch import optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import MeshSpec, use_mesh

# The tolerances of tests/test_torch_train_gpt2.py: fp32 on both sides,
# sums over 256 positions and 128-wide products taken in other orders.
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
# fp32 logits of magnitude up to ~1 from the same weights: the products and
# the RoPE angles round differently in the two libraries.
LOGIT_TOL = 1e-4

_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype="fp32", logits_dtype=None, **kw):
    jdt, tdt = _DTYPES[dtype]
    jldt, tldt = _DTYPES[logits_dtype or dtype]
    return (dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jdt,
                                logits_dtype=jldt, **kw),
            dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=tdt,
                                logits_dtype=tldt, **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jllama.init_params(jcfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1024, (2, 129)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _t(a):
    return torch.as_tensor(a, dtype=torch.long)


def _leaves_with_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _port_loss_and_grads(jax_params, batch, tcfg, mesh=None):
    params = convert.params_from_numpy(jax_params, device="cpu")
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    if mesh is None:
        loss = tllama.loss_fn(params, *map(_t, batch), tcfg)
        grads = torch.autograd.grad(loss, leaves)
    else:
        with use_mesh(mesh):
            loss = tllama.loss_fn(params, *map(_t, batch), tcfg)
            grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


# ------------------------------------------------ tests/test_llama.py cases
def test_forward_shapes_and_param_count():
    _, config = _configs(dtype="bf16")
    params = tllama.init_params(config, seed=0, device="cpu")
    counted = sum(p.numel() for p in optim.tree_leaves(params))
    assert counted == tllama.num_params(config)
    logits = tllama.forward(params, torch.zeros((2, config.seq_len),
                                                dtype=torch.long), config)
    assert logits.shape == (2, config.seq_len, config.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def _tile_kv(w, cfg):
    """(L, D, KV*hd) -> each kv head repeated for its q_per_kv query heads
    -> (L, D, H*hd): an MHA model computing the GQA one."""
    L, D = w.shape[:2]
    heads = w.reshape(L, D, cfg.n_kv_head, cfg.head_dim)
    return heads.repeat_interleave(cfg.q_per_kv, dim=2).reshape(L, D, -1)


def test_gqa_equivalent_to_mha_with_tiled_kv():
    """GQA equals MHA whose wk/wv repeat each kv head for its query group
    (tests/test_llama.py:25-55). The kv heads differ, so a port that tiled
    the heads (``Tensor.repeat``) instead would differ: the control."""
    shape = dict(vocab_size=256, n_layer=1, n_head=4, d_model=64, d_ff=128,
                 seq_len=32, dtype=torch.float32, attn_impl="xla")
    gqa = tllama.LlamaConfig(n_kv_head=2, **shape)
    mha = tllama.LlamaConfig(n_kv_head=4, **shape)
    params = tllama.init_params(gqa, seed=1, device="cpu")
    wk, wv = params["blocks"]["wk"], params["blocks"]["wv"]
    assert not torch.equal(wk[..., :16], wk[..., 16:])
    params_mha = dict(params, blocks=dict(
        params["blocks"], wk=_tile_kv(wk, gqa), wv=_tile_kv(wv, gqa)))
    tokens = _t(np.random.default_rng(2).integers(0, 256, (2, 32)))
    out_gqa = tllama.forward(params, tokens, gqa)
    out_mha = tllama.forward(params_mha, tokens, mha)
    torch.testing.assert_close(out_gqa, out_mha, rtol=1e-5, atol=1e-5)

    def tiled(w):  # the wrong expansion: whole groups of heads repeated
        L, D = w.shape[:2]
        return w.reshape(L, D, 2, 16).repeat(1, 1, 2, 1).reshape(L, D, -1)

    wrong = dict(params, blocks=dict(params["blocks"], wk=tiled(wk),
                                     wv=tiled(wv)))
    assert (tllama.forward(wrong, tokens, mha) - out_gqa).abs().max() > 1e-4


def test_rope_is_position_sensitive():
    x = torch.ones((1, 8, 2, 16))
    rotated = tllama._rope(x, 10000.0)
    assert not torch.allclose(rotated[0, 0], rotated[0, 5])
    # Position 0 rotates by angle 0: unchanged.
    torch.testing.assert_close(rotated[0, 0], x[0, 0], rtol=1e-6, atol=0)


def test_tiny_training_step_reduces_loss():
    """tests/test_llama.py's 15 steps at lr 1e-2 on one batch of 4, on the
    port: the loss falls by more than 0.5, as the reference's does."""
    _, config = _configs(dtype="bf16")
    opt = tllama.make_optimizer(learning_rate=1e-2)
    params = tllama.init_params(config, seed=0, device="cpu")
    opt_state = opt.init(params)
    step = tllama.make_train_step(config, opt)
    rng = np.random.default_rng(0)
    toks = _t(rng.integers(0, config.vocab_size, (4, config.seq_len + 1)))
    losses = []
    for _ in range(15):
        params, opt_state, loss = step(params, opt_state, toks[:, :-1],
                                       toks[:, 1:])
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses[::5]


# ------------------------------------------------- against the JAX function
def test_rope_matches_jax_at_1024_positions():
    """Angles up to 1023 rad: fp32 cos and sin of large angles differ by a
    few ulp between libraries. Against eager JAX the port is within 2e-6;
    against jitted JAX (what the model runs; XLA's own cos/sin) 5.6e-5 was
    measured on values up to ~5, so the tolerance is 1e-4."""
    x = np.random.default_rng(0).normal(size=(2, 1024, 4, 64)).astype(
        np.float32)
    got = tllama._rope(torch.from_numpy(x), 10000.0).numpy()
    eager = np.asarray(jllama._rope(jnp.asarray(x), 10000.0))
    jitted = np.asarray(jax.jit(lambda a: jllama._rope(a, 10000.0))(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, eager, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-4)
    bf16 = tllama._rope(torch.from_numpy(x).bfloat16(), 10000.0)
    assert bf16.dtype == torch.bfloat16


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 128)).astype(np.float32)
    scale = rng.normal(size=(128,)).astype(np.float32)
    got = tllama._rmsnorm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(scale), 1e-5)
    want = jllama._rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                           1e-5)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["xla", "splash", "ring"])
def test_forward_and_loss_match_jax_fp32(jax_params, batch, attn_impl):
    """Logits and the loss; "ring" under a seq axis of 4 on both sides
    (S_local 32: the einsum body)."""
    jcfg, tcfg = _configs(attn_impl=attn_impl)
    toks, tgts = map(jnp.asarray, batch)

    def jax_side():
        return (np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, jcfg))(
                    jax_params, toks)),
                float(jax.jit(lambda p, t, y: jllama.loss_fn(p, t, y, jcfg))(
                    jax_params, toks, tgts)))

    params = convert.params_from_numpy(jax_params, device="cpu")
    if attn_impl == "ring":
        with set_mesh(jmake_mesh(JMeshSpec(seq=4))):
            want_logits, want_loss = jax_side()
        with use_mesh(MeshSpec(seq=4)):
            logits = tllama.forward(params, _t(batch[0]), tcfg)
            loss = tllama.loss_fn(params, *map(_t, batch), tcfg)
    else:
        want_logits, want_loss = jax_side()
        logits = tllama.forward(params, _t(batch[0]), tcfg)
        loss = tllama.loss_fn(params, *map(_t, batch), tcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 128, 1024)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "splash", "ring"])
def test_loss_and_every_gradient_match_jax(jax_params, batch, attn_impl):
    """jax.value_and_grad of the remat'd (jax.checkpoint per layer) loss
    against autograd through the port's whole-layer checkpoints."""
    jcfg, tcfg = _configs(attn_impl=attn_impl)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t, y: jllama.loss_fn(p, t, y, jcfg)))
    mesh = None
    if attn_impl == "ring":
        mesh = MeshSpec(seq=4)
        with set_mesh(jmake_mesh(JMeshSpec(seq=4))):
            want_loss, want = grad_fn(jax_params, *map(jnp.asarray, batch))
    else:
        want_loss, want = grad_fn(jax_params, *map(jnp.asarray, batch))
    loss, grads = _port_loss_and_grads(jax_params, batch, tcfg, mesh)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    names = [n for n, _ in _leaves_with_names(want)]
    assert len(names) == len(grads) == 12
    for (name, w), g in zip(_leaves_with_names(want), grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_remat_gives_identical_loss_and_gradients(jax_params, batch):
    """The whole-layer checkpoint changes what reruns, not the numbers."""
    _, tcfg = _configs(attn_impl="splash")
    loss, grads = _port_loss_and_grads(jax_params, batch, tcfg)
    loss_nr, grads_nr = _port_loss_and_grads(
        jax_params, batch, dataclasses.replace(tcfg, remat=False))
    assert loss == loss_nr
    for g, r in zip(grads, grads_nr):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_remat_reruns_each_layers_attention(monkeypatch, jax_params, batch):
    """One loss and gradient of the 2-layer model runs SplashAttention's
    forward twice a layer (the checkpoint reruns the layer in the
    backward) and its backward once: on the card, the splash kernels'
    launches (chip_smoke.py counts 16 + 8 a step at 8 layers)."""
    from ray_tpu_torch.ops import attention

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = attention.attention_reference, attention.attention_bwd_reference

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(attention, "attention_reference", count("fwd", fwd))
    monkeypatch.setattr(attention, "attention_bwd_reference",
                        count("bwd", bwd))
    _, tcfg = _configs(attn_impl="splash")
    _port_loss_and_grads(jax_params, batch, tcfg)
    assert calls == {"fwd": 4, "bwd": 2}


def test_forward_and_loss_match_jax_bf16(jax_params, batch):
    """bf16 matmuls on both sides, to tests/test_torch_gpt2.py's 2e-2 on the
    logits and 1e-3 on the loss (the frameworks round to bf16 at other
    points). ``forward`` gives fp32 logits; ``loss_fn`` rounds them to bf16
    (``logits_dtype``) before the fp32 logsumexp: each held on its own."""
    jcfg, tcfg = _configs(dtype="bf16", attn_impl="xla")
    params = convert.params_from_numpy(jax_params, device="cpu")
    toks, tgts = map(jnp.asarray, batch)
    want = np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, jcfg))(
        jax_params, toks), np.float32)
    logits = tllama.forward(params, _t(batch[0]), tcfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, atol=2e-2)
    want_loss = float(jax.jit(lambda p, t, y: jllama.loss_fn(p, t, y, jcfg))(
        jax_params, toks, tgts))
    loss = tllama.loss_fn(params, *map(_t, batch), tcfg)
    np.testing.assert_allclose(float(loss), want_loss, atol=1e-3)
    # The bf16 logits of loss_fn: its loss differs from the fp32-logit loss
    # of the same hidden states by the rounding the reference also does.
    fp32_logits = dataclasses.replace(tcfg, logits_dtype=torch.float32)
    jfp32 = dataclasses.replace(jcfg, logits_dtype=jnp.float32)
    want32 = float(jax.jit(lambda p, t, y: jllama.loss_fn(p, t, y, jfp32))(
        jax_params, toks, tgts))
    np.testing.assert_allclose(
        float(tllama.loss_fn(params, *map(_t, batch), fp32_logits)), want32,
        atol=1e-3)


@pytest.mark.parametrize("config", [
    dict(), dict(vocab_size=1024, n_layer=2, n_head=4, n_kv_head=2,
                 d_model=128, d_ff=384, seq_len=128),
    dict(n_layer=32, d_model=4096, n_head=32, n_kv_head=8, d_ff=14336,
         vocab_size=128256, seq_len=8192)])
def test_num_params_and_flops_match_jax(config):
    jcfg, tcfg = jllama.LlamaConfig(**config), tllama.LlamaConfig(**config)
    assert tllama.num_params(tcfg) == jllama.num_params(jcfg)
    assert tllama.flops_per_token(tcfg) == jllama.flops_per_token(jcfg)


def test_config_defaults_and_layout_match_jax():
    jcfg, tcfg = jllama.LlamaConfig(), tllama.LlamaConfig()
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "logits_dtype"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == tcfg.logits_dtype == torch.bfloat16
    assert (tcfg.head_dim, tcfg.q_per_kv) == (64, 2)
    assert tllama.num_params(tcfg) == 56_369_664
    jt, tt = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    assert dataclasses.astuple(dataclasses.replace(jt, dtype=None,
                                                   logits_dtype=None)) == \
        dataclasses.astuple(dataclasses.replace(tt, dtype=None,
                                                logits_dtype=None))
    want = jax.eval_shape(lambda: jllama.init_params(jt, jax.random.key(0)))
    got = tllama.init_params(tt, seed=0, device="cpu")
    assert tllama.logical_axes(tt) == jllama.logical_axes(jt)
    flat = dict(_leaves_with_names(got))
    assert set(flat) == {n for n, _ in _leaves_with_names(want)}
    for name, w in _leaves_with_names(want):
        assert tuple(flat[name].shape) == tuple(w.shape), name
        assert flat[name].dtype == torch.float32, name
    assert torch.equal(flat["blocks.attn_norm"], torch.ones(2, 128))
    assert abs(float(flat["wte"].std()) - 0.02) < 1e-3
    assert abs(float(flat["blocks.wo"].std()) - 0.01) < 1e-3  # 0.02/sqrt(4)


def test_one_train_step_matches_optax(jax_params, batch):
    """make_train_step with make_optimizer (GPT-2's: clip 1.0, bf16 first
    moment) against the JAX step with optax, from the same weights: the
    loss, then every updated leaf within 5% of one step (lr 3e-4). The
    gradients agree to ~1e-6 relative, but Adam's first update is
    g / (|g| + eps): an entry whose gradient is near zero moves a few
    percent of a step differently (3.4%, 1.01e-5, measured in w_up; the
    GPT-2 test's 1e-5 is 3.3%)."""
    jcfg, tcfg = _configs(attn_impl="splash")
    jopt = jllama.make_optimizer(learning_rate=3e-4)
    jstep = jax.jit(jllama.make_train_step(jcfg, jopt))
    jparams = jax.tree.map(jnp.asarray, jax_params)
    new, _, want_loss = jstep(jparams, jopt.init(jparams),
                              *map(jnp.asarray, batch))
    opt = tllama.make_optimizer(learning_rate=3e-4)
    assert opt.mu_dtype == torch.bfloat16 and opt.grad_clip == 1.0
    params = convert.params_from_numpy(jax_params, device="cpu")
    step = tllama.make_train_step(tcfg, opt)
    params, state, loss = step(params, opt.init(params), *map(_t, batch))
    assert state["count"] == 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for (name, w), p in zip(_leaves_with_names(jax.tree.map(np.asarray, new)),
                            optim.tree_leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=0.05 * 3e-4, err_msg=name)


def test_pipeline_stages_raise():
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError, match="pp_stages"):
        tllama.make_train_step(dataclasses.replace(tcfg, pp_stages=2),
                               tllama.make_optimizer())


def test_init_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.init_params(tllama.LlamaConfig.tiny())
    assert tllama.init_params(tllama.LlamaConfig.tiny(), device="cpu")


def test_cpu_path_launches_no_kernel(jax_params, batch):
    from ray_tpu_torch.ops import attention, ring_attention

    attention.reset_launches()
    ring_attention.reset_launches()
    _, tcfg = _configs(attn_impl="splash")
    _port_loss_and_grads(jax_params, batch, tcfg)
    assert not any(attention.LAUNCHES.values())
    assert not any(ring_attention.LAUNCHES.values())
