"""APPO — asynchronous PPO: IMPALA's actor-learner architecture with the
PPO clipped surrogate over V-trace-corrected advantages.

The port of ``ray_tpu/rl/algorithms/appo.py`` (ref: rllib/algorithms/appo/
appo.py APPOConfig/APPO — 'asynchronous variant of PPO based on the IMPALA
architecture'; loss in rllib/algorithms/appo/torch/appo_torch_learner.py —
clipped surrogate with importance ratios against the behavior policy,
V-trace value targets, periodic target-network refresh).

Inherits IMPALA's async sampling loop, fragment batching and V-trace; only
the loss differs. The behaviour policy is the last broadcast snapshot, which
the ratio clips against: the runners' log-probs come from the weights they
sampled with, since a broadcast is a copy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rl.core.rl_module import Columns


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.clip_param = 0.4  # ref: appo.py default clip
        self.use_kl_loss = False
        self.kl_coeff = 1.0
        self.kl_target = 0.01


class APPOLearner(IMPALALearner):
    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        (dist, inputs, target_logp, values, mask, denom, vs, pg_adv) = \
            self._vtrace_terms(batch)
        # PPO clipped surrogate with ratios against the BEHAVIOR policy
        # (the last broadcast snapshot) — ref: appo_torch_learner.py.
        ratio = torch.exp(target_logp - batch[Columns.ACTION_LOGP])
        surrogate = torch.minimum(
            pg_adv * ratio,
            pg_adv * torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param))
        policy_loss = -(surrogate * mask).sum() / denom
        value_loss = 0.5 * (torch.square(values - vs) * mask).sum() / denom
        entropy = (dist.entropy(inputs) * mask).sum() / denom
        total = (policy_loss + cfg.vf_loss_coeff * value_loss
                 - cfg.entropy_coeff * entropy)
        metrics = {"policy_loss": policy_loss, "vf_loss": value_loss,
                   "entropy": entropy,
                   "mean_ratio": (ratio * mask).sum() / denom}
        if cfg.use_kl_loss:
            kl = ((batch[Columns.ACTION_LOGP] - target_logp) * mask).sum() / denom
            # The ADAPTIVE coefficient rides the batch as a 0-d entry;
            # APPO._augment_batch injects it, _after_learn adapts it toward
            # kl_target (ref: appo.py after_train_step).
            kl_coeff = batch.get("kl_coeff", cfg.kl_coeff)
            total = total + kl_coeff * torch.clamp_min(kl, 0.0)
            metrics["mean_kl"] = kl
        return total, metrics


class APPO(IMPALA):
    learner_class = APPOLearner
    config_class = APPOConfig

    def _augment_batch(self, batch):
        cfg = self.algo_config
        if cfg.use_kl_loss:
            if not hasattr(self, "_kl_coeff"):
                self._kl_coeff = float(cfg.kl_coeff)
            batch["kl_coeff"] = np.float32(self._kl_coeff)
        return batch

    def _after_learn(self, results) -> None:
        """Adaptive KL schedule toward kl_target (ref: appo.py / PPO's: 1.5x
        when overshooting 2x target, halve under 0.5x)."""
        cfg = self.algo_config
        kl = results.get("mean_kl")
        if not cfg.use_kl_loss or kl is None:
            return
        if kl > 2.0 * cfg.kl_target:
            self._kl_coeff *= 1.5
        elif kl < 0.5 * cfg.kl_target:
            self._kl_coeff *= 0.5
        results["curr_kl_coeff"] = self._kl_coeff
