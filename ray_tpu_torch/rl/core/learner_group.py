"""LearnerGroup — one local or N remote learners with gradient sync.

The port of ``ray_tpu/rl/core/learner_group.py`` (ref: rllib/core/learner/
learner_group.py:80 LearnerGroup — n remote Learner actors, update()
fan-out with batch sharding, get_weights from learner 0). Remote learners
are ``ray_tpu_torch`` actors; their gradients meet in the collective group
each joins at construction.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch


class LearnerGroup:
    def __init__(self, *, learner_class: type, config, module_spec,
                 num_learners: int = 0, seed: int = 0):
        self.num_learners = num_learners
        self._local = None
        self._remote: List[Any] = []
        self._group_name: Optional[str] = None
        if num_learners <= 1:
            # In-process learner (ref: learner_group "local mode" when
            # num_learners=0).
            self._local = learner_class(config=config, module_spec=module_spec,
                                        seed=seed)
        else:
            group_name = self._group_name = f"learners-{uuid.uuid4().hex[:8]}"
            cls = ray_tpu_torch.remote(learner_class)
            self._remote = [
                cls.remote(config=config, module_spec=module_spec, rank=r,
                           world_size=num_learners, group_name=group_name,
                           seed=seed)
                for r in range(num_learners)
            ]
            ray_tpu_torch.get([lr.ping.remote() for lr in self._remote])

    # ------------------------------------------------------------------
    def update_from_batch(self, batch: Dict[str, np.ndarray], *,
                          num_epochs: int = 1,
                          minibatch_size: Optional[int] = None) -> Dict[str, Any]:
        """DP-shard the batch over learners; grads allreduce inside each
        learner's update (ref: learner_group.py update_from_batch)."""
        if self._local is not None:
            return self._local.update_from_batch(
                batch, num_epochs=num_epochs, minibatch_size=minibatch_size)
        rows = {k: v for k, v in batch.items() if np.ndim(v) > 0}
        scalars = {k: v for k, v in batch.items() if np.ndim(v) == 0}
        n = len(next(iter(rows.values())))
        world = len(self._remote)
        shard = n // world
        if shard == 0:
            raise ValueError(f"batch of {n} rows cannot shard over {world} learners")
        per_learner_mb = (max(1, minibatch_size // world)
                          if minibatch_size else None)
        refs = []
        for r, learner in enumerate(self._remote):
            # EQUAL shards (up to world-1 remainder rows dropped): every rank
            # must run the identical number of minibatches or the gradient
            # allreduce deadlocks on the odd one out.
            sl = slice(r * shard, (r + 1) * shard)
            sub = {k: v[sl] for k, v in rows.items()}
            sub.update(scalars)
            refs.append(learner.update_from_batch.remote(
                sub, num_epochs=num_epochs, minibatch_size=per_learner_mb))
        results = ray_tpu_torch.get(refs)
        return {k: float(np.mean([m[k] for m in results])) for k in results[0]}

    # ------------------------------------------------------------------
    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._remote[0].get_weights.remote())

    def get_state(self) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._remote[0].get_state.remote())

    def set_state(self, state: Dict[str, Any]) -> None:
        if self._local is not None:
            self._local.set_state(state)
        else:
            ray_tpu_torch.get([lr.set_state.remote(state) for lr in self._remote])

    def foreach_learner(self, fn_name: str, *args, **kwargs) -> List[Any]:
        """``fn_name(*args, **kwargs)`` on every learner, their results in
        rank order (DQN's ``compute_td_errors``)."""
        if self._local is not None:
            return [getattr(self._local, fn_name)(*args, **kwargs)]
        return ray_tpu_torch.get([getattr(lr, fn_name).remote(*args, **kwargs)
                                  for lr in self._remote])

    def stop(self) -> None:
        for lr in self._remote:
            try:
                ray_tpu_torch.kill(lr)
            except Exception:  # noqa: BLE001 — a dead learner is already gone
                pass
        if self._group_name is not None:
            from ray_tpu_torch import collective

            collective.destroy_collective_group(self._group_name)
            self._group_name = None
