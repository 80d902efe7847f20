"""The port's MLP (ray_tpu_torch.models.mlp) against the JAX package's
(ray_tpu/models/mlp.py, 784-128-64-10), and the list-shaped parameters
through the converter and the optimizer.

Both sides get JAX's init as numpy through the converter, which now walks
lists, and the same inputs (numpy, from a seed), in fp32: logits, loss,
accuracy and every gradient within 1e-5 (a 784-wide product summed in
other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu_torch import optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import mlp as tmlp

TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jmlp.init_params(jax.random.key(0)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(64, 784)).astype(np.float32),
            rng.integers(0, 10, 64).astype(np.int32))


def test_list_round_trip_through_convert(jax_params):
    params = convert.params_from_numpy(jax_params, device="cpu")
    assert isinstance(params, list) and len(params) == 3
    assert [tuple(p["w"].shape) for p in params] == [(784, 128), (128, 64),
                                                     (64, 10)]
    back = convert.params_to_numpy(params)
    assert isinstance(back, list)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    nested = {"layers": jax_params, "pair": (np.ones(2, np.float32),)}
    got = convert.params_from_numpy(nested, device="cpu")
    assert isinstance(got["pair"], tuple)
    assert isinstance(convert.params_to_numpy(got)["layers"], list)


def test_forward_loss_and_accuracy_match_jax(jax_params, data):
    params = convert.params_from_numpy(jax_params, device="cpu")
    x, y = data
    np.testing.assert_allclose(
        tmlp.forward(params, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.forward(jax_params, jnp.asarray(x))),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(tmlp.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y))),
        float(jmlp.loss_fn(jax_params, jnp.asarray(x), jnp.asarray(y))),
        rtol=TOL)
    assert float(tmlp.accuracy(params, torch.from_numpy(x),
                               torch.from_numpy(y))) == \
        float(jmlp.accuracy(jax_params, jnp.asarray(x), jnp.asarray(y)))


def test_every_gradient_matches_jax(jax_params, data):
    x, y = data
    want = jax.grad(jmlp.loss_fn)(jax_params, jnp.asarray(x), jnp.asarray(y))
    params = convert.params_from_numpy(jax_params, device="cpu")
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(
        tmlp.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y)),
        leaves)
    want_leaves = jax.tree.leaves(want)  # the same order: layer, then b, w
    assert len(grads) == len(want_leaves) == 6
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=TOL)


def test_init_scheme_and_device(monkeypatch):
    params = tmlp.init_params(0, device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [(784, 128), (128, 64),
                                                     (64, 10)]
    for layer, d_in in zip(params, (784, 128, 64)):
        assert torch.equal(layer["b"], torch.zeros_like(layer["b"]))
        # He init: std sqrt(2 / d_in).
        assert abs(float(layer["w"].std()) / (2.0 / d_in) ** 0.5 - 1) < 0.1
    assert torch.equal(params[0]["w"], tmlp.init_params(0, device="cpu")[0]["w"])
    small = tmlp.init_params(1, sizes=(4, 3), device="cpu")
    assert len(small) == 1 and small[0]["w"].shape == (4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmlp.init_params(0)


def test_adamw_on_the_list_matches_optax(jax_params, data):
    """The port's optimizer walks the MLP's list: three steps of make_step
    with optax.adamw's settings (no clip, fp32 moment) against JAX's."""
    x, y = data
    jopt = optax.adamw(1e-3, b1=0.9, b2=0.999, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, jax_params)
    js = jopt.init(jp)

    @jax.jit
    def jstep(p, s):
        loss, g = jax.value_and_grad(jmlp.loss_fn)(p, jnp.asarray(x),
                                                   jnp.asarray(y))
        u, s = jopt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    topt = optim.AdamW(learning_rate=1e-3, b2=0.999, weight_decay=0.01,
                       grad_clip=float("inf"), mu_dtype=torch.float32)
    params = convert.params_from_numpy(jax_params, device="cpu")
    state = topt.init(params)
    assert isinstance(state["mu"], list)
    step = optim.make_step(tmlp.loss_fn, topt)
    for _ in range(3):
        jp, js, jloss = jstep(jp, js)
        params, state, loss = step(params, state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    # Within 5% of one step (Adam's g / (|g| + eps) on near-zero entries).
    for got, want in zip(optim.tree_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=0.05 * 1e-3)
