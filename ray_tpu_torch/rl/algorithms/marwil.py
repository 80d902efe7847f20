"""MARWIL — Monotonic Advantage Re-Weighted Imitation Learning.

The port of ``ray_tpu/rl/algorithms/marwil.py`` (ref: rllib/algorithms/
marwil/marwil.py MARWILConfig/MARWIL; loss in rllib/algorithms/marwil/torch/
marwil_torch_learner.py — behavior cloning re-weighted by
exp(beta * advantage), advantage = return-to-go - V(s), normalized by a
second moment; Wang et al. 2018).

Shares the offline substrate with BC (OfflineData over flat transition
rows); the returns-to-go column is derived once at setup from the dataset's
reward/terminated/truncated columns (row order is episode order — see
``offline.record_episodes``). ``beta=0`` recovers plain BC plus a value
baseline.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rl.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.rl_module import Columns


class MARWILConfig(BCConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        #: Advantage re-weighting temperature (0 = BC + value baseline).
        self.beta = 1.0
        self.vf_coeff = 1.0
        #: Exponent clip keeping exp(beta * adv_norm) finite early in
        #: training (the reference bounds via its moving-average norm).
        self.max_advantage_exponent = 10.0


class MARWILLearner(TorchLearner):
    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        out = self.module.forward_train(batch[Columns.OBS])
        dist = self.module.action_dist
        inputs = out[Columns.ACTION_DIST_INPUTS]
        logp = dist.logp(inputs, batch[Columns.ACTIONS])
        values = out[Columns.VF_PREDS]
        adv = batch["returns"] - values
        # Batch second-moment normalizer (the reference's stationary-offline
        # stand-in for a moving average).
        adv_const = adv.detach()
        norm = torch.sqrt(torch.mean(torch.square(adv_const)) + 1e-8)
        exponent = torch.clamp(cfg.beta * adv_const / norm,
                               -cfg.max_advantage_exponent,
                               cfg.max_advantage_exponent)
        weights = torch.exp(exponent)
        policy_loss = -torch.mean(weights * logp)
        vf_loss = torch.mean(torch.square(adv))
        entropy = dist.entropy(inputs).mean()
        total = policy_loss + cfg.vf_coeff * vf_loss
        coeff = getattr(cfg, "entropy_coeff", 0.0)
        if coeff:
            total = total - coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "mean_advantage": adv.mean(),
                       "bc_logp": logp.mean(), "entropy": entropy}


def returns_to_go(rewards: np.ndarray, boundaries: np.ndarray,
                  gamma: float) -> np.ndarray:
    """Discounted return from each step to its episode's end, computed over
    flat transition rows in episode order. ``boundaries`` marks the LAST
    step of each episode (terminated OR truncated — returns must not bleed
    across a time-limit cut); the dataset tail counts as a boundary."""
    out = np.zeros(len(rewards), np.float32)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if boundaries[i]:
            acc = 0.0
        acc = float(rewards[i]) + gamma * acc
        out[i] = acc
    return out


class MARWIL(BC):
    learner_class = MARWILLearner
    config_class = MARWILConfig

    def setup(self, config) -> None:
        super().setup(config)
        if getattr(self.offline, "is_streaming", False):
            # Whole-dataset returns-to-go needs every episode in memory; a
            # streaming window can't provide that. Precomputed returns
            # stream through sample() fine.
            if not self.offline.has_column("returns"):
                raise ValueError(
                    "MARWIL on a streaming OfflineData needs a precomputed "
                    "'returns' column (returns-to-go derivation requires the "
                    "full dataset in memory; use streaming=False)")
            return
        cols = self.offline.columns
        if "returns" not in cols:
            if Columns.REWARDS not in cols:
                raise ValueError(
                    "MARWIL needs a 'returns' or 'rewards' column in the "
                    "offline dataset")
            if Columns.TERMINATEDS not in cols:
                # Without boundary flags returns-to-go would treat the
                # whole dataset as ONE episode — silently wrong advantages.
                raise ValueError(
                    "MARWIL needs episode boundaries to derive returns: "
                    "provide a 'returns' column, or record the dataset "
                    "with terminateds/truncateds (offline.record_episodes "
                    "emits both)")
            n = self.offline.size
            term = np.asarray(cols[Columns.TERMINATEDS])
            if Columns.TRUNCATEDS in cols:
                trunc = np.asarray(cols[Columns.TRUNCATEDS])
            else:
                warnings.warn(
                    "offline dataset has no truncateds column (recorded "
                    "before truncation tracking): returns-to-go will bleed "
                    "across time-limit episode cuts", RuntimeWarning,
                    stacklevel=2)
                trunc = np.zeros(n)
            cols["returns"] = returns_to_go(
                np.asarray(cols[Columns.REWARDS], np.float32),
                (term > 0) | (trunc > 0), self.algo_config.gamma)
