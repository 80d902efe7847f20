"""AdamW with a bf16 first moment: the port of ``make_optimizer`` in
``ray_tpu/models/gpt2.py`` (:471-485).

The reference is ``optax.chain(clip_by_global_norm(grad_clip),
adamw(lr, b1, b2, eps=1e-8, weight_decay, mu_dtype))``. This module repeats
that arithmetic, operation by operation, so a port run and a JAX run from the
same parameters and gradients agree:

- clip: ``g <- g`` if ``norm < max_norm`` else ``g / norm * max_norm``, with
  ``norm`` the global L2 norm over every leaf; ``grad_clip=math.inf`` (ViT's
  bare ``optax.adamw``) skips the clip and takes no norm;
- ``mu <- (1 - b1) g + b1 mu``; with ``mu_dtype=bfloat16`` optax multiplies
  the stored bf16 moment by a weakly typed Python float, so JAX rounds
  ``b1`` to bf16 (0.8984375); under ``jit``, as the JAX step runs, XLA
  keeps the product in fp32 (eager JAX rounds it to bf16 as well, and the
  two updates part by more than 1e-3 within three steps:
  ``tests/test_torch_train_gpt2.py``). The sum is fp32 and feeds the
  update; only the stored mu is rounded to bf16;
- ``nu <- (1 - b2) g^2 + b2 nu`` in fp32;
- ``p <- p - lr (mu_hat / (sqrt(nu_hat) + eps) + wd p)`` on every leaf, with
  the bias corrections ``1 - b**count`` in fp32.

``torch.optim.AdamW`` keeps ``exp_avg`` in the parameter's type, so it cannot
hold a bf16 moment beside fp32 weights; and the optimizer has no Pallas
kernel in the reference, so this is plain PyTorch. Parameters are updated in
place (JAX returns new arrays); the state is ``{"count", "mu", "nu"}`` with
``mu`` and ``nu`` nested like the parameters and ``count`` a Python int, so
a step needs no read from the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

#: Nested dicts (and lists, as the MLP's layers) of tensors.
Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return [tree]
    return [leaf for v in tree for leaf in tree_leaves(v)]


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclass(frozen=True)
class AdamW:
    """Global-norm clipping then AdamW, as ``make_optimizer`` builds it."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    mu_dtype: torch.dtype = torch.bfloat16

    def init(self, params: Tree) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
        }

    @torch.no_grad()
    def update(self, grads: Tree, state: Dict[str, Any], params: Tree
               ) -> Dict[str, Any]:
        """One step: updates ``params`` and the moments in place and returns
        the state with the count advanced."""
        g_leaves = [g.float() for g in tree_leaves(grads)]
        p_leaves = tree_leaves(params)
        mu_leaves = tree_leaves(state["mu"])
        nu_leaves = tree_leaves(state["nu"])
        # grad_clip=inf is optax.adamw without the clip: no norm is taken.
        clip = math.isfinite(self.grad_clip)
        if clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in g_leaves))
            keep = norm < self.grad_clip
        count = state["count"] + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        # b1 in the stored moment's type (JAX's weak typing), product in fp32.
        b1_mu = float(torch.tensor(self.b1, dtype=self.mu_dtype))
        for g, p, mu, nu in zip(g_leaves, p_leaves, mu_leaves, nu_leaves):
            if clip:
                g = torch.where(keep, g, g / norm * self.grad_clip)
            m = (1 - self.b1) * g + mu.float() * b1_mu
            v = (1 - self.b2) * (g * g) + self.b2 * nu
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = (u + self.weight_decay * p) * -self.learning_rate
            p.add_(u.to(p.dtype))
            mu.copy_(m)
            nu.copy_(v)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95, grad_clip: float = 1.0,
                   mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with the first moment stored in bf16 by default; pass
    ``mu_dtype=torch.float32`` for a full-precision moment."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 b1=b1, b2=b2, grad_clip=grad_clip,
                 mu_dtype=torch.bfloat16 if mu_dtype is None else mu_dtype)


def make_step(loss: Callable[..., torch.Tensor], optimizer: AdamW):
    """``(params, opt_state, *batch) -> (params, opt_state, loss)`` for
    ``loss(params, *batch)``: the counterpart of a JAX step of
    ``jax.value_and_grad(loss)``, ``optimizer.update`` and
    ``optax.apply_updates``, with one difference: JAX returns new arrays,
    while here the parameters are leaf tensors updated in place under
    ``no_grad`` and the same tree is returned. Leaves that do not require
    grad yet are switched to ``requires_grad``. Gradients come from
    ``torch.autograd.grad``, so no ``.grad`` is left behind. The loss comes
    back detached, still on the device: reading it (``float``) waits for the
    step."""
    def step(params: Tree, opt_state, *batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        value = loss(params, *batch)
        grads = iter(torch.autograd.grad(value, leaves))
        grad_tree = tree_map(lambda _: next(grads), params)
        opt_state = optimizer.update(grad_tree, opt_state, params)
        return params, opt_state, value.detach()

    return step
