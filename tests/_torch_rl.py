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
    the i-th state's names under ``prefixes[i]``."""
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    out = {}
    for state, prefix in zip(states, prefixes):
        mu, nu = _flat(state.mu), _flat(state.nu)
        for k in mu:
            out[prefix(k) if callable(prefix) else prefix + k] = (mu[k], nu[k])
    return out


def _port_moments(optimizers, module):
    names = {id(p): n for n, p in module.named_parameters()}
    out = {}
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state[p]
                out[names[id(p)]] = (_ref_layout(st["exp_avg"]),
                                     _ref_layout(st["exp_avg_sq"]))
    return out


def _assert_learner_equal(jparams, jmoments, pmodule, pmoments, tol=UPDATE_TOL):
    """Every weight within ``tol``; every moment the port keeps within
    ``tol``, and the reference's for the rest (target networks, which the
    port leaves out of its optimizers) zero."""
    want, got = _flat(_np_tree(jparams)), _flat(rl_params_to_numpy(pmodule))
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
