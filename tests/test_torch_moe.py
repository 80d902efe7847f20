"""The port's single-device MoE (ray_tpu_torch.models.moe) against the JAX
package's, in fp32 on the CPU.

The routing (``_route``) gets the same tokens and router weights on both
sides: the dispatch tensor must be equal element for element, the combine
weights within 1e-6 and the aux loss within 1e-6 relative, with router
weights at the model's init scale (0.02). The router's product and softmax
round in other orders in the two libraries, by ulps of the logits: with
tests/test_pipeline.py's unit-normal router the logits reach ~11, whose ulp
is 9.5e-7, and the combine weights move by up to 1.94e-6 (measured), so
that case is held to 4e-6. No token sits that near a tie on these seeded
inputs. The model gets the same parameters (JAX's
init, as numpy, through the converter) and tokens at ``MoEConfig.tiny()``
(2 layers, D=128, 4 heads, S=64, 4 experts of 256, top-2): forward, loss
with the aux term, and every gradient, to the tolerances of
tests/test_torch_train_gpt2.py. tests/test_pipeline.py's routing case is
mirrored; its two expert-parallel cases wait for the ``expert`` axis
(ROADMAP.md, Queue 1 item 3), and their replicated half is held here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu_torch import optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.parallel import Mesh, MeshSpec, use_mesh

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
LOGIT_TOL = 1e-4
COMBINE_TOL = {0.02: 1e-6, 1.0: 4e-6}  # by the router weights' scale


def _configs(**kw):
    return (dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(tmoe.MoEConfig.tiny(), dtype=torch.float32,
                                **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jmoe.init_params(jcfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1024, (2, 65)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _t(a):
    return torch.as_tensor(a, dtype=torch.long)


def _leaves_with_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _route_inputs(n, seed, config, w_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, config.d_model)).astype(np.float32),
            (rng.normal(size=(config.d_model, config.n_experts))
             * w_scale).astype(np.float32))


# ---------------------------------------- tests/test_pipeline.py's MoE case
def test_moe_routing_capacity_and_weights():
    config = tmoe.MoEConfig.tiny()
    x, w = _route_inputs(64, 0, config)
    dispatch, combine, aux = tmoe._route(torch.from_numpy(x),
                                         torch.from_numpy(w), config)
    N, E, C = dispatch.shape
    # No expert over capacity; each token dispatched <= top_k times.
    assert (dispatch.sum(dim=(0, 2)) <= C + 1e-6).all()
    per_token = dispatch.sum(dim=(1, 2))
    assert (per_token <= config.top_k + 1e-6).all()
    # Combine weights of a dispatched token sum to ~1.
    kept = per_token > 0
    csum = combine.sum(dim=(1, 2))
    torch.testing.assert_close(csum[kept], torch.ones(int(kept.sum())),
                               rtol=1e-5, atol=0)
    assert float(aux) > 0


# ------------------------------------------------- against the JAX function
@pytest.mark.parametrize("w_scale", [0.02, 1.0], ids=["init", "unit"])
@pytest.mark.parametrize("n,seed,capacity_factor", [
    (64, 0, 1.25), (128, 1, 1.25), (512, 2, 1.25),
    # Capacity below demand: choices are dropped, the 2nd choices first.
    (256, 3, 0.25), (130, 4, 0.5)])
def test_route_matches_jax(n, seed, capacity_factor, w_scale):
    jcfg, tcfg = _configs(capacity_factor=capacity_factor)
    x, w = _route_inputs(n, seed, tcfg, w_scale)
    want = [np.asarray(a) for a in jax.jit(
        lambda x, w: jmoe._route(x, w, jcfg))(jnp.asarray(x), jnp.asarray(w))]
    got = [a.numpy() for a in tmoe._route(torch.from_numpy(x),
                                          torch.from_numpy(w), tcfg)]
    assert got[0].shape == want[0].shape == (n, 4, tcfg.capacity(n))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=COMBINE_TOL[w_scale])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
    if capacity_factor < 1:
        assert want[0].sum() < n * tcfg.top_k  # some choices were dropped


def test_route_breaks_ties_to_the_first_expert():
    """Equal router logits: every token's first choice is expert 0 and its
    second expert 1, as jnp.argmax takes the first maximum."""
    jcfg, tcfg = _configs()
    x = np.ones((16, tcfg.d_model), np.float32)
    w = np.zeros((tcfg.d_model, tcfg.n_experts), np.float32)
    want = np.asarray(jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg)[0])
    got = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), tcfg)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(dim=2)[:, :2] == 1).all() and got[:, 2:].sum() == 0


def test_route_gradient_matches_jax():
    """The gates and the aux loss carry the router's gradient (the one-hots
    carry none): d(sum(combine * r) + aux) / d(x, w) on both sides."""
    jcfg, tcfg = _configs()
    x, w = _route_inputs(128, 5, tcfg)
    r = np.random.default_rng(6).normal(
        size=(128, 4, tcfg.capacity(128))).astype(np.float32)

    def jf(x, w):
        _, comb, aux = jmoe._route(x, w, jcfg)
        return jnp.sum(comb * r) + aux

    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    _, comb, aux = tmoe._route(xt, wt, tcfg)
    got = torch.autograd.grad((comb * torch.from_numpy(r)).sum() + aux,
                              (xt, wt))
    for g, a in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [1, 8, 64, 130, 8192, 16384])
def test_capacity_matches_jax(n):
    jcfg, tcfg = jmoe.MoEConfig(), tmoe.MoEConfig()
    assert tcfg.capacity(n) == jcfg.capacity(n)
    assert tcfg.capacity(n) % 8 == 0


@pytest.mark.parametrize("attn_impl", ["xla", "auto"])
def test_forward_and_loss_match_jax(jax_params, batch, attn_impl):
    """Logits, the aux loss summed over layers, and the loss with its
    ``aux_loss_weight`` term. "auto" is the splash path in the port (its
    plain version on the CPU) and plain attention in JAX off a TPU (JAX's
    splash kernel takes no S=64)."""
    jcfg, tcfg = _configs(attn_impl=attn_impl)
    toks, tgts = map(jnp.asarray, batch)
    want_logits, want_aux = jax.jit(lambda p, t: jmoe.forward(p, t, jcfg))(
        jax_params, toks)
    want_loss = jax.jit(lambda p, t, y: jmoe.loss_fn(p, t, y, jcfg))(
        jax_params, toks, tgts)
    params = convert.params_from_numpy(jax_params, device="cpu")
    logits, aux = tmoe.forward(params, _t(batch[0]), tcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 1024)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    loss = tmoe.loss_fn(params, *map(_t, batch), tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "auto"])
def test_loss_and_every_gradient_match_jax(jax_params, batch, attn_impl):
    """jax.value_and_grad through the routing, the experts and the
    remat'd blocks, against autograd through the port's checkpoints."""
    jcfg, tcfg = _configs(attn_impl=attn_impl)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, t, y: jmoe.loss_fn(p, t, y, jcfg)))(
            jax_params, *map(jnp.asarray, batch))
    params = convert.params_from_numpy(jax_params, device="cpu")
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tmoe.loss_fn(params, *map(_t, batch), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    named = list(_leaves_with_names(want))
    assert len(named) == len(grads) == 17
    for (name, w), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_replicated_forward_matches_jax():
    """The replicated half of tests/test_pipeline.py's
    ``test_moe_expert_parallel_matches_replicated``: its configuration with
    no mesh, JAX's init through the converter, to its 2e-4 / 1e-4."""
    kw = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, seq_len=16,
              n_experts=4, expert_mlp=64, remat=False, attn_impl="xla")
    jcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw)
    tcfg = tmoe.MoEConfig(dtype=torch.float32, **kw)
    jp = jmoe.init_params(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(1).integers(0, 128, (4, 16)).astype(
        np.int32)
    ref, aux_ref = jmoe.forward(jp, jnp.asarray(tokens), jcfg)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    got, aux = tmoe.forward(params, _t(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-4)


def test_train_step_reduces_loss():
    """tests/test_pipeline.py's MoE train step on one device: its config,
    five steps of the port's AdamW at lr 1e-2, losses finite and falling."""
    config = tmoe.MoEConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                            seq_len=32, n_experts=4, expert_mlp=128,
                            dtype=torch.float32, attn_impl="xla")
    opt = optim.make_optimizer(1e-2, weight_decay=0.0,
                               mu_dtype=torch.float32)
    params = tmoe.init_params(config, seed=0, device="cpu")
    opt_state = opt.init(params)
    step = tmoe.make_train_step(config, opt)
    tokens = _t(np.random.default_rng(0).integers(0, 256, (8, 32)))
    targets = torch.roll(tokens, -1, dims=1)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_config_and_layout_match_jax():
    jcfg, tcfg = jmoe.MoEConfig(), tmoe.MoEConfig()
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.dtype == torch.bfloat16
    for c in (tcfg, tmoe.MoEConfig.tiny()):
        j = dataclasses.replace(jmoe.MoEConfig.tiny() if c.n_layer == 2
                                else jcfg)
        assert tmoe.num_params(c) == jmoe.num_params(j)
        view = c._attn_view()
        assert (view.n_head, view.d_model, view.attn_impl, view.dtype) == \
            (c.n_head, c.d_model, c.attn_impl, c.dtype)
    jt, tt = jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny()
    assert tmoe.logical_axes(tt) == jmoe.logical_axes(jt)
    want = jax.eval_shape(lambda: jmoe.init_params(jt, jax.random.key(0)))
    got = dict(_leaves_with_names(tmoe.init_params(tt, seed=0,
                                                   device="cpu")))
    assert set(got) == {n for n, _ in _leaves_with_names(want)}
    for name, w in _leaves_with_names(want):
        assert tuple(got[name].shape) == tuple(w.shape), name
    assert tmoe.num_params(tt) == sum(t.numel() for t in got.values())


def test_expert_axis_raises_until_it_is_ported(batch):
    """An expert axis above 1 spans the process group, so one process
    refuses it (the expert-parallel path runs in a gloo world:
    tests/test_torch_mesh_models.py). Plain tensors run the one-device
    function whatever mesh is ambient: no mesh, a folded one, or one of
    the expert axis."""
    _, tcfg = _configs(attn_impl="xla")
    params = tmoe.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="process group has 1"):
        with use_mesh(MeshSpec(expert=2)):
            pass
    want = tmoe.forward(params, _t(batch[0]), tcfg)[0]
    with use_mesh(Mesh(MeshSpec(expert=2))):
        assert torch.equal(tmoe.forward(params, _t(batch[0]), tcfg)[0], want)
    with use_mesh(MeshSpec(seq=2)):  # another axis: the same function
        logits, _ = tmoe.forward(params, _t(batch[0]), tcfg)
    assert torch.equal(logits, want)


def test_init_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmoe.init_params(tmoe.MoEConfig.tiny())
    assert tmoe.init_params(tmoe.MoEConfig.tiny(), device="cpu")
