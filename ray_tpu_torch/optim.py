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
import sys
import time
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
        g_leaves = tree_leaves(grads)
        p_leaves = tree_leaves(params)
        mu_leaves = tree_leaves(state["mu"])
        nu_leaves = tree_leaves(state["nu"])
        # grad_clip=inf is optax.adamw without the clip: no norm is taken.
        clip = math.isfinite(self.grad_clip)
        if clip:
            norm = torch.sqrt(_sum_of_squares(g_leaves))
            keep = norm < self.grad_clip
        # Every leaf's update is elementwise, so on a device mesh it runs on
        # each rank's shard (a gradient, its parameter and its moments are
        # placed alike): only the norm above needs the mesh.
        g_leaves = [_local(g).float() for g in g_leaves]
        p_leaves, mu_leaves, nu_leaves = (
            [_local(t) for t in leaves]
            for leaves in (p_leaves, mu_leaves, nu_leaves))
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place ops update the DTensor),
    else ``t``."""
    from ray_tpu_torch._private.torch_compat import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _sum_of_squares(leaves: List[torch.Tensor]) -> torch.Tensor:
    """The sum of every leaf's squared entries, in fp32. DTensor leaves add
    their local sums, each divided by the copies the mesh holds of it (the
    product of the dimensions it is replicated on), and one sum over the
    mesh's ranks gives the whole tree's."""
    from ray_tpu_torch._private.torch_compat import is_dtensor

    if not any(is_dtensor(g) for g in leaves):
        return sum(torch.sum(g.float() * g.float()) for g in leaves)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = next(g for g in leaves if is_dtensor(g)).device_mesh
    total = 0.0
    for g in leaves:
        local = _local(g).float()
        copies = math.prod(n for n, pl in zip(mesh.shape, g.placements)
                           if isinstance(pl, Replicate))
        total = total + torch.sum(local * local) / copies
    return DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                              run_check=False).full_tensor()


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95, grad_clip: float = 1.0,
                   mu_dtype: Optional[torch.dtype] = None) -> AdamW:
    """AdamW with the first moment stored in bf16 by default; pass
    ``mu_dtype=torch.float32`` for a full-precision moment."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 b1=b1, b2=b2, grad_clip=grad_clip,
                 mu_dtype=torch.bfloat16 if mu_dtype is None else mu_dtype)


def _as_placed(grads, leaves) -> List[torch.Tensor]:
    """Each gradient on a device mesh redistributed to its parameter's
    placements. Autograd leaves a weight's gradient a ``Partial`` sum over
    the mesh dimensions its batch shards ran on; the redistribution is the
    all-reduce (or reduce-scatter, for a sharded weight) that XLA derives in
    the reference, and the clip's norm and the update need it done. Inside
    a profiled train loop the rank first waits for its backward and for
    every rank to reach the sync; then the sync is waited for and its wall
    time alone goes to the step profiler's ``collective`` bucket."""
    from ray_tpu_torch._private.torch_compat import is_dtensor

    if not any(is_dtensor(g) for g in grads):
        return list(grads)
    prof = sys.modules.get("ray_tpu_torch.train.profiler")
    timed = prof is not None and prof.active_profiler() is not None
    if timed:
        # The backward still queued on the card, and the peers' (which may
        # share it), are compute, not the sync: wait for both first.
        local = next(g.to_local() for g in grads if is_dtensor(g))
        if local.is_cuda:
            torch.cuda.synchronize(local.device)
        import torch.distributed as dist

        dist.barrier()
    t0 = time.time()
    out = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(g)
           else g for g, p in zip(grads, leaves)]
    if timed:
        for g in out:
            local = g.to_local() if is_dtensor(g) else g
            if hasattr(local, "wait"):
                local.wait()
            if local.is_cuda:
                torch.cuda.synchronize(local.device)
        prof.record("collective", t0, time.time())
    return out


def _global(value: torch.Tensor) -> torch.Tensor:
    """A loss on a device mesh as one plain tensor: the global value."""
    from ray_tpu_torch._private.torch_compat import is_dtensor

    return value.full_tensor() if is_dtensor(value) else value


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
    step. Parameters that are DTensors on a device mesh
    (``parallel.create_sharded_state``) get their gradients placed as they
    are before the update, so the clip's norm is over the whole tree; the
    loss comes back as the global mean, a plain tensor."""
    def step(params: Tree, opt_state, *batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        value = loss(params, *batch)
        grads = iter(_as_placed(torch.autograd.grad(value, leaves), leaves))
        grad_tree = tree_map(lambda _: next(grads), params)
        opt_state = optimizer.update(grad_tree, opt_state, params)
        return params, opt_state, _global(value.detach())

    return step
