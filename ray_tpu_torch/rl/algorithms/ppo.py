"""PPO — Proximal Policy Optimization, new-API-stack shape.

The port of ``ray_tpu/rl/algorithms/ppo.py`` (ref: rllib/algorithms/ppo/
ppo.py PPOConfig/PPO; loss in rllib/algorithms/ppo/torch/
ppo_torch_learner.py — clipped surrogate + clipped value loss + entropy
bonus + the adaptive KL penalty; north-star workload tuned_examples/ppo/
cartpole_ppo.py reaching default_reward=450).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.connectors import (ConnectorPipeline, GeneralAdvantageEstimation,
                                         batch_episodes, strip_internal)
from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.rl_module import Columns, RLModule


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 3e-4
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.use_gae = True
        self.lambda_ = 0.95
        self.num_epochs = 6
        self.minibatch_size = 128
        self.train_batch_size = 4000
        self.normalize_advantages = True


def make_vf_fn(module: RLModule) -> Callable[[Optional[Dict[str, torch.Tensor]], Any],
                                             torch.Tensor]:
    """``vf(params, obs)``: the value head of ``module`` run with
    ``params`` (a state dict, moved to the module's device), or with its
    own parameters when ``params`` is None. Returns a tensor on the
    module's device."""
    dev = next(module.parameters()).device

    def vf(params, obs) -> torch.Tensor:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs), dtype=torch.float32).to(dev)
            if params is None:
                out = module.forward_train(x)
            else:
                out = functional_call(module, {k: v.to(dev) for k, v in params.items()},
                                      (x,))
            return out[Columns.VF_PREDS]

    return vf


class PPOLearner(TorchLearner):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.vf_fn = make_vf_fn(self.module)

    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        out = self.module.forward_train(batch[Columns.OBS])
        dist = self.module.action_dist
        inputs = out[Columns.ACTION_DIST_INPUTS]
        logp = dist.logp(inputs, batch[Columns.ACTIONS])
        logp_ratio = torch.exp(logp - batch[Columns.ACTION_LOGP])
        advantages = batch[Columns.ADVANTAGES]

        surrogate = torch.minimum(
            advantages * logp_ratio,
            advantages * torch.clamp(logp_ratio, 1 - cfg.clip_param,
                                     1 + cfg.clip_param))
        policy_loss = -surrogate.mean()

        vf_preds = out[Columns.VF_PREDS]
        vf_targets = batch[Columns.VALUE_TARGETS]
        vf_loss = torch.square(vf_preds - vf_targets)
        vf_loss_clipped = torch.clamp(vf_loss, 0, cfg.vf_clip_param)
        value_loss = vf_loss_clipped.mean()

        entropy = dist.entropy(inputs).mean()
        # Approx KL(old || new) (ref: ppo_torch_learner.py mean_kl_loss);
        # penalized with the ADAPTIVE kl coefficient the algorithm threads
        # through the batch as a 0-d value.
        kl = (batch[Columns.ACTION_LOGP] - logp).mean()
        kl_coeff = batch.get("kl_coeff", 0.0)

        total = (policy_loss + cfg.vf_loss_coeff * value_loss
                 - cfg.entropy_coeff * entropy
                 + kl_coeff * torch.clamp_min(kl, 0.0))
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": value_loss,
            "entropy": entropy,
            "mean_kl": kl,
        }


class PPO(Algorithm):
    learner_class = PPOLearner
    config_class = PPOConfig
    supports_multi_agent = True

    def build_learner_connector(self) -> ConnectorPipeline:
        cfg = self.algo_config
        return ConnectorPipeline([
            batch_episodes,
            GeneralAdvantageEstimation(
                gamma=cfg.gamma, lambda_=cfg.lambda_,
                normalize_advantages=cfg.normalize_advantages),
            strip_internal,
        ])

    def training_step(self) -> Dict[str, Any]:
        """Sample, GAE, update, sync. ``timers`` splits the step's host
        seconds into sampling and learning (GAE, the update and the weight
        sync), and gives the update's own (its minibatches, ending in their
        metrics' one copy back) as ``update_s``."""
        cfg = self.algo_config
        if cfg.is_multi_agent():
            return self._multi_agent_training_step()
        t0 = time.perf_counter()
        episodes = self._sample_batch()
        t1 = time.perf_counter()
        # GAE uses current learner params; the local learner's value fn runs
        # on its own tensors, remote groups bootstrap with learner-0 params
        # through a module copy built here.
        if self.learner_group._local is not None:
            vf_fn = self.learner_group._local.vf_fn
            params = None
        else:
            if not hasattr(self, "_driver_vf"):
                self._driver_vf = make_vf_fn(
                    self.module_spec.build(device=self.device))
            vf_fn = self._driver_vf
            params = self.learner_group.get_weights()
        batch = self.learner_connector({}, episodes, params=params, vf_fn=vf_fn)
        if not hasattr(self, "_kl_coeff"):
            self._kl_coeff = float(cfg.kl_coeff)
        batch["kl_coeff"] = np.float32(self._kl_coeff)
        t_update = time.perf_counter()
        learner_results = self.learner_group.update_from_batch(
            batch, num_epochs=cfg.num_epochs, minibatch_size=cfg.minibatch_size)
        update_s = time.perf_counter() - t_update
        # Adaptive KL coefficient (ref: ppo.py after_train_step — x1.5 when
        # kl overshoots 2x target, x0.5 when under 0.5x).
        kl = learner_results.get("mean_kl")
        if kl is not None and cfg.kl_coeff > 0:
            if kl > 2.0 * cfg.kl_target:
                self._kl_coeff *= 1.5
            elif kl < 0.5 * cfg.kl_target:
                self._kl_coeff *= 0.5
            learner_results["curr_kl_coeff"] = self._kl_coeff
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        t2 = time.perf_counter()
        return {"learners": learner_results,
                "timers": {"sample_s": t1 - t0, "learn_s": t2 - t1,
                           "update_s": update_s}}

    def _multi_agent_training_step(self) -> Dict[str, Any]:
        """Independent PPO per policy: route each agent's trajectories to its
        module's learner group, update every policy, sync all weights (ref:
        multi-agent PPO via MultiRLModule in the reference's learner;
        independent learning is its default multi-agent regime)."""
        cfg = self.algo_config
        ma_episodes = self._sample_batch()
        by_module: Dict[str, list] = {}
        for ma_ep in ma_episodes:
            for mid, eps in ma_ep.episodes_by_module().items():
                by_module.setdefault(mid, []).extend(eps)
        if not hasattr(self, "_kl_coeffs"):
            self._kl_coeffs = {mid: float(cfg.kl_coeff)
                               for mid in self.learner_groups}
        results: Dict[str, Any] = {}
        for mid, episodes in by_module.items():
            group = self.learner_groups[mid]
            learner = group._local
            if learner is None:
                raise ValueError("multi-agent PPO drives local (in-process) "
                                 "learner groups; set num_learners <= 1")
            batch = self.learner_connector(
                {}, episodes, params=None, vf_fn=learner.vf_fn)
            batch["kl_coeff"] = np.float32(self._kl_coeffs[mid])
            res = group.update_from_batch(
                batch, num_epochs=cfg.num_epochs,
                minibatch_size=cfg.minibatch_size)
            kl = res.get("mean_kl")
            if kl is not None and cfg.kl_coeff > 0:
                if kl > 2.0 * cfg.kl_target:
                    self._kl_coeffs[mid] *= 1.5
                elif kl < 0.5 * cfg.kl_target:
                    self._kl_coeffs[mid] *= 0.5
            results[mid] = res
        self.env_runner_group.sync_weights(self.get_weights())
        return {"learners": results}
