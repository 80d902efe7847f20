"""The port's ViT (ray_tpu_torch.models.vit) against the JAX package's, case
by case with tests/test_vit.py, then the JAX functions themselves.

Both sides get the same parameters (JAX's init, as numpy, through the
converter) and the same images (numpy, from a seed) at ``ViTConfig.tiny()``
(32x32 images in 8x8 patches, 2 layers, D=64, 4 heads, d_ff 128, 10
classes), in fp32 for the parity cases. The two sharded cases of
tests/test_vit.py wait for the data, fsdp and tensor axes (ROADMAP.md,
Queue 1 item 3).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu_torch import optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import vit as tvit

# fp32 on both sides (tests/test_torch_train_gpt2.py's tolerances): sums
# over 17 tokens and 64-wide products taken in other orders.
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
LOGIT_TOL = 1e-5


def _configs(dtype="fp32"):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jvit.ViTConfig.tiny(), dtype=jdt),
            dataclasses.replace(tvit.ViTConfig.tiny(), dtype=tdt))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jvit.init_params(jcfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 4).astype(np.int32))


def _leaves_with_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# -------------------------------------------------- tests/test_vit.py cases
def test_forward_shapes_and_dtype():
    _, tiny = _configs("bf16")
    params = tvit.init_params(tiny, seed=0, device="cpu")
    logits = tvit.forward(params, torch.zeros((2, 32, 32, 3)), tiny)
    assert logits.shape == (2, tiny.num_classes)
    assert logits.dtype == torch.float32


def test_patchify_exact():
    """Patch unfolding is a pure relayout: every pixel lands in exactly the
    patch and position the (row-major patches, row-major pixels, RGB-last)
    layout dictates, and equals JAX's element for element."""
    jcfg, tiny = _configs()
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    patches = tvit.patchify(torch.from_numpy(img), tiny).numpy()
    assert patches.shape == (2, 16, tiny.patch_dim)
    p = tiny.patch_size
    np.testing.assert_array_equal(patches[0, 0], img[0, :p, :p, :].reshape(-1))
    np.testing.assert_array_equal(patches[0, -1],
                                  img[0, -p:, -p:, :].reshape(-1))
    np.testing.assert_array_equal(
        patches, np.asarray(jvit.patchify(jnp.asarray(img), jcfg)))


@pytest.mark.parametrize("config", [{}, "tiny"])
def test_num_params_matches(config):
    jcfg = jvit.ViTConfig.tiny() if config == "tiny" else jvit.ViTConfig()
    tcfg = tvit.ViTConfig.tiny() if config == "tiny" else tvit.ViTConfig()
    assert tvit.num_params(tcfg) == jvit.num_params(jcfg)
    if config == "tiny":
        params = tvit.init_params(tcfg, seed=0, device="cpu")
        assert sum(p.numel() for p in optim.tree_leaves(params)) == \
            tvit.num_params(tcfg)
    else:
        assert tvit.num_params(tcfg) == 86_530_792  # ViT-B/16


def test_learns_separable_classes():
    """Constant-color images per class (tests/test_vit.py's case, marked
    slow there for JAX's compile on a contended box; the port's 30 steps
    take a few seconds): the loss falls to a fifth, the accuracy passes the
    reference's bf16 bar (0.75)."""
    _, tiny = _configs("bf16")
    rng = np.random.default_rng(0)
    n, s = 64, tiny.image_size
    labels = rng.integers(0, 4, n)
    colors = np.eye(3)[labels % 3] * (1 + labels[:, None] // 3)
    images = np.broadcast_to(
        colors[:, None, None, :], (n, s, s, 3)).astype(np.float32)
    images = images + rng.normal(0, 0.05, images.shape).astype(np.float32)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)

    optimizer = tvit.make_optimizer(learning_rate=3e-3)
    params = tvit.init_params(tiny, seed=0, device="cpu")
    opt_state = optimizer.init(params)
    step = tvit.make_train_step(tiny, optimizer)
    first = None
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, x, y)
        if first is None:
            first = float(loss)
    assert float(loss) < first * 0.2, (first, float(loss))
    with torch.no_grad():
        acc = float(tvit.accuracy(params, x, y, tiny))
    assert acc > 0.75, acc


# ------------------------------------------------- against the JAX function
def test_forward_and_loss_match_jax(jax_params, data):
    jcfg, tcfg = _configs()
    params = convert.params_from_numpy(jax_params, device="cpu")
    images, labels = data
    want = np.asarray(jax.jit(lambda p, x: jvit.forward(p, x, jcfg))(
        jax_params, jnp.asarray(images)))
    got = tvit.forward(params, torch.from_numpy(images), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    want_loss = float(jvit.loss_fn(jax_params, jnp.asarray(images),
                                   jnp.asarray(labels), jcfg))
    loss = tvit.loss_fn(params, torch.from_numpy(images),
                        torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    acc = float(tvit.accuracy(params, torch.from_numpy(images),
                              torch.from_numpy(labels), tcfg))
    assert acc == float(jvit.accuracy(jax_params, jnp.asarray(images),
                                      jnp.asarray(labels), jcfg))


def test_forward_matches_jax_bf16(jax_params, data):
    """bf16 matmuls on both sides, to tests/test_torch_gpt2.py's 2e-2 on
    the logits (the layernorms return bf16 here, so the rounding points are
    the reference's; matmul accumulation orders differ)."""
    jcfg, tcfg = _configs("bf16")
    params = convert.params_from_numpy(jax_params, device="cpu")
    want = np.asarray(jax.jit(lambda p, x: jvit.forward(p, x, jcfg))(
        jax_params, jnp.asarray(data[0])), np.float32)
    got = tvit.forward(params, torch.from_numpy(data[0]), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


def test_layernorm_keeps_the_input_type():
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    out = tvit._layernorm(x, torch.ones(64), torch.zeros(64))
    assert out.dtype == torch.bfloat16
    want = jvit._layernorm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                           jnp.ones(64), jnp.zeros(64))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


def test_loss_and_every_gradient_match_jax(jax_params, data):
    jcfg, tcfg = _configs()
    images, labels = data
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, x, y: jvit.loss_fn(p, x, y, jcfg)))(
            jax_params, jnp.asarray(images), jnp.asarray(labels))
    params = convert.params_from_numpy(jax_params, device="cpu")
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tvit.loss_fn(params, torch.from_numpy(images),
                        torch.from_numpy(labels), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    named = list(_leaves_with_names(want))
    assert len(named) == len(grads) == 18
    for (name, w), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_optimizer_step_matches_optax_adamw():
    """make_optimizer is optax.adamw(lr, b1, b2=0.999, weight_decay=0.05):
    no clip, an fp32 first moment. Gradients whose global norm is far above
    1 (a clip would rescale them) and one leaf of zeros: three steps of the
    port's AdamW against optax's, every parameter and moment within 1e-7
    (fp32, the same operations in the same order)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(16, 8)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                    "z": np.zeros((3,), np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 10).astype(
        np.float32), params) for _ in range(3)]
    for g in grads:
        g["b"]["z"][:] = 0.0
    jopt = jvit.make_optimizer(learning_rate=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = tvit.make_optimizer(learning_rate=1e-2)
    assert topt.grad_clip == math.inf and topt.mu_dtype == torch.float32
    assert (topt.b2, topt.weight_decay) == (0.999, 0.05)
    tp = convert.params_from_numpy(params, device="cpu")
    ts = topt.init(tp)
    for g in grads:
        upd, js = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(convert.params_from_numpy(g, device="cpu"), ts, tp)
    assert ts["count"] == 3
    for (name, w), got in zip(_leaves_with_names(jax.tree.map(np.asarray,
                                                              jp)),
                              optim.tree_leaves(tp)):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-7,
                                   err_msg=name)
    mu = jax.tree.map(np.asarray, js[0].mu)
    for (name, w), got in zip(_leaves_with_names(mu),
                              optim.tree_leaves(ts["mu"])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_one_train_step_matches_jax(jax_params, data):
    """make_train_step with the ViT optimizer against the JAX step (jit),
    from the same weights: loss, then every parameter within 5% of a step
    (Adam's first update is g / (|g| + eps), so a near-zero gradient's
    entry moves a few percent of a step differently)."""
    jcfg, tcfg = _configs()
    lr = 3e-4
    jopt = jvit.make_optimizer(learning_rate=lr)
    jstep = jax.jit(jvit.make_train_step(jcfg, jopt))
    jp = jax.tree.map(jnp.asarray, jax_params)
    new, _, want_loss = jstep(jp, jopt.init(jp), *map(jnp.asarray, data))
    topt = tvit.make_optimizer(learning_rate=lr)
    params = convert.params_from_numpy(jax_params, device="cpu")
    step = tvit.make_train_step(tcfg, topt)
    params, _, loss = step(params, topt.init(params),
                           *map(torch.from_numpy, data))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for (name, w), p in zip(_leaves_with_names(jax.tree.map(np.asarray, new)),
                            optim.tree_leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=0.05 * lr, err_msg=name)


def test_config_defaults_and_layout_match_jax():
    jb, tb = jvit.ViTConfig.base(), tvit.ViTConfig.base()
    for f in dataclasses.fields(jb):
        if f.name != "dtype":
            assert getattr(tb, f.name) == getattr(jb, f.name), f.name
    assert (tb.n_patches, tb.patch_dim) == (196, 768)
    jt, tt = jvit.ViTConfig.tiny(), tvit.ViTConfig.tiny()
    assert tvit.logical_axes(tt) == jvit.logical_axes(jt)
    want = jax.eval_shape(lambda: jvit.init_params(jt, jax.random.key(0)))
    got = dict(_leaves_with_names(tvit.init_params(tt, seed=0,
                                                   device="cpu")))
    assert set(got) == {n for n, _ in _leaves_with_names(want)}
    for name, w in _leaves_with_names(want):
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert got[name].dtype == torch.float32


def test_init_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvit.init_params(tvit.ViTConfig.tiny())
    assert tvit.init_params(tvit.ViTConfig.tiny(), device="cpu")
