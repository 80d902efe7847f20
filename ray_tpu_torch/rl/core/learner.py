"""TorchLearner — gradient updates on the learner's device, with gradient
sync through the port's collective for several learners.

The port of ``ray_tpu/rl/core/learner.py`` (``JaxLearner``; ref:
rllib/core/learner/learner.py:109 Learner — compute_gradients:461,
apply_gradients:604, update_from_batch:967; torch_learner.py:62).

One minibatch update is: the loss and its gradients (``compute_loss``,
``backward``), with ``world_size > 1`` the gradients flattened into one
vector, all-reduced through ``ray_tpu_torch.collective`` and divided by the
world size, then optax's ``clip_by_global_norm`` (``g`` if the global norm
is below ``grad_clip``, else ``g / norm * grad_clip``) and
``torch.optim.Adam(lr)``, whose ``sqrt(v_hat) + eps`` is optax's. The
reported ``grad_norm`` is the norm before the clip. Minibatches follow the
reference's numpy permutation (``default_rng(steps)``), so a multi-epoch
``update_from_batch`` visits the rows in the reference's order. The batch
goes to the device once per call, and the metrics come back to the host
once, at its end.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.optim import tree_map
from ray_tpu_torch.rl.core.rl_module import RLModuleSpec


def host_copy(tree: Any) -> Any:
    """Host copies of every tensor of nested dicts and lists (a state dict,
    an optimizer's state, a broadcast's params); other leaves as they are.
    The learner's optimizer updates its tensors in place, so what leaves
    it must carry the values of this moment, not references to them."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)


class TorchLearner:
    """Base learner; algorithms override ``compute_loss``."""

    def __init__(self, *, config, module_spec: RLModuleSpec, rank: int = 0,
                 world_size: int = 1, group_name: Optional[str] = None,
                 seed: int = 0):
        self.config = config
        self.device = resolve_device(getattr(config, "device", None))
        self.module = module_spec.build(seed=seed, device=self.device)
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed * 31 + rank)
        self._params = [p for p in self.module.parameters() if p.requires_grad]
        self.optimizer = self.configure_optimizer()
        self._steps = 0
        self._synced = world_size > 1 and bool(group_name)
        if self._synced:
            from ray_tpu_torch import collective

            collective.init_collective_group(world_size, rank,
                                             group_name=group_name)

    # ------------------------------------------------------------------
    def configure_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(self._params, lr=getattr(self.config, "lr", 3e-4))

    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Return (scalar loss, metrics dict of 0-d tensors) for one
        minibatch on the learner's device."""
        raise NotImplementedError

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The module's own tensors (not copies), by parameter name."""
        return self.module.state_dict()

    # ------------------------------------------------------------------
    def _update(self, mb: Dict[str, torch.Tensor]
                ) -> Tuple[List[str], torch.Tensor]:
        """One minibatch step; its metrics' names and values (on the
        device)."""
        self.optimizer.zero_grad()
        loss, metrics = self.compute_loss(mb, self._generator)
        loss.backward()
        for p in self._params:
            if p.grad is None:
                # A parameter the loss does not read (BC's value head):
                # optax's Adam sees a zero gradient for it, so does this one.
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        if self._synced:
            from ray_tpu_torch import collective

            flat = torch.cat([g.reshape(-1) for g in grads])
            flat = collective.allreduce(flat, group_name=self.group_name,
                                        rank=self.rank) / self.world_size
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = getattr(self.config, "grad_clip", None)
        if clip:
            keep = norm < clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * clip))
        self.optimizer.step()
        names = [*metrics, "total_loss", "grad_norm"]
        values = torch.stack([*(v.detach().float() for v in metrics.values()),
                              loss.detach(), norm])
        return names, values

    def update_from_batch(self, batch: Dict[str, Any],
                          *, num_epochs: int = 1,
                          minibatch_size: Optional[int] = None) -> Dict[str, Any]:
        """SGD over the batch (ref: learner.py:967 update_from_batch —
        num_epochs/minibatch_size shuffled passes)."""
        # Scalars (0-d) ride along whole — e.g. PPO's adaptive kl_coeff —
        # while row arrays are minibatch-sliced.
        rows = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items() if np.ndim(v) > 0}
        scalars = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                   for k, v in batch.items() if np.ndim(v) == 0}
        n = len(next(iter(rows.values())))
        minibatch_size = minibatch_size or n
        names: List[str] = []
        values: List[torch.Tensor] = []
        for _ in range(num_epochs):
            # Same permutation on every learner rank (synced collective
            # schedule requires identical minibatch counts).
            perm = torch.from_numpy(
                np.random.default_rng(self._steps).permutation(n)).to(self.device)
            for start in range(0, n, minibatch_size):
                idx = perm[start:start + minibatch_size]
                mb = {k: v.index_select(0, idx) for k, v in rows.items()}
                mb.update(scalars)
                names, vals = self._update(mb)
                values.append(vals)
            self._steps += 1
        host = torch.stack(values).cpu().numpy().astype(np.float64)
        out = {k: float(np.mean(host[:, i])) for i, k in enumerate(names)}
        self.after_update(out)
        return out

    def after_update(self, metrics: Dict[str, Any]) -> None:
        """Hook (e.g. DQN target-net sync)."""

    # ------------------------------------------------------------------
    def get_weights(self) -> Dict[str, torch.Tensor]:
        """Copies of the module's tensors, on the learner's device."""
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def get_state(self) -> Dict[str, Any]:
        """Host copies of the params, the optimizer's state and the step
        count (what a checkpoint holds)."""
        return {"params": host_copy(self.module.state_dict()),
                "opt_state": host_copy(self.optimizer.state_dict()),
                "steps": self._steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        # Copy on receipt: in-process actors share object-store values by
        # reference, and this learner's optimizer updates its tensors in
        # place — adopting another's tensors would let a later update
        # change values someone else still holds.
        # The optimizer's copy stays on the host: load_state_dict moves the
        # moments to the parameters' device and keeps Adam's step count on
        # the host, where the (non-capturable) Adam wants it.
        self.module.load_state_dict(state["params"])
        self.optimizer.load_state_dict(host_copy(state["opt_state"]))
        self._steps = state.get("steps", 0)

    def ping(self) -> str:
        return "pong"
