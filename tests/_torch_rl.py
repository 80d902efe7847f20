"""Comparing an RL learner of the port with the JAX package's: weights
and Adam moments by the reference's parameter paths (``pi.layers.0.w``),
conv kernels in the reference's HWIO layout."""

import jax
import numpy as np
import optax
import torch

from ray_tpu_torch.models.convert import rl_params_to_numpy

#: Weights, TD errors and Adam moments absolutely, metrics also relatively.
UPDATE_TOL = 5e-6


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    """name -> leaf of nested dicts, lists and tuples (``pi.layers.0.w``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _ref_layout(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).contiguous().numpy()


def _ref_moments(opt_state, prefixes=("",)):
    """name -> (mu, nu) of every ``ScaleByAdamState`` in ``opt_state``,
    the i-th state's names under ``prefixes[i]``. Several optimizers' states
    go in as one tuple (DreamerV3's ``(wm_state, ac_state)``), their Adam
    states taken in that order."""
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    out = {}
    for state, prefix in zip(states, prefixes):
        mu, nu = _flat(state.mu), _flat(state.nu)
        for k in mu:
            out[prefix(k) if callable(prefix) else prefix + k] = (mu[k], nu[k])
    return out


def _port_moments(optimizers, module, layout=None):
    """name -> (mu, nu) of every parameter of ``optimizers`` (one or
    several, e.g. DreamerV3's world-model and actor-critic Adams), named by
    ``module``'s parameter names, each moment in the reference's layout:
    ``layout(name, tensor)`` (default: conv kernels OIHW -> HWIO)."""
    names = {id(p): n for n, p in module.named_parameters()}
    if layout is None:
        def layout(name, t):
            return _ref_layout(t)
    out = {}
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state[p]
                name = names[id(p)]
                out[name] = tuple(
                    np.asarray(layout(name, st[k].detach().cpu())).copy()
                    for k in ("exp_avg", "exp_avg_sq"))
    return out


def _assert_learner_equal(jparams, jmoments, pmodule, pmoments, tol=UPDATE_TOL,
                          to_numpy=rl_params_to_numpy):
    """Every weight within ``tol``; every moment the port keeps within
    ``tol``, and the reference's for the rest (target networks, which the
    port leaves out of its optimizers) zero. ``to_numpy`` gives the port's
    weights as the reference's tree."""
    want, got = _flat(_np_tree(jparams)), _flat(to_numpy(pmodule))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    assert set(pmoments) <= set(jmoments)
    for k, (mu, nu) in jmoments.items():
        if k in pmoments:
            np.testing.assert_allclose(pmoments[k][0], mu, atol=tol, rtol=0,
                                       err_msg=f"mu {k}")
            np.testing.assert_allclose(pmoments[k][1], nu, atol=tol, rtol=0,
                                       err_msg=f"nu {k}")
        else:
            assert not np.any(mu) and not np.any(nu), k


def _assert_metrics_equal(got, want, tol=UPDATE_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol,
                                   rtol=tol, err_msg=k)
