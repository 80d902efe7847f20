"""CQL — conservative Q-learning (offline SAC variant).

The port of ``ray_tpu/rl/algorithms/cql.py`` (ref: rllib/algorithms/cql/
cql.py CQLConfig/CQL; loss in rllib/algorithms/cql/torch/
cql_torch_learner.py — SAC losses plus the CQL(H) regularizer: logsumexp of
Q over random + policy actions minus the dataset Q, weighted by
min_q_weight). Built on ``SACLearner``'s step through its
``critic_penalty`` hook; the penalty's noise is drawn with the step's, after
SAC's: the uniform actions, then one normal draw per policy sample.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig, SACLearner
from ray_tpu_torch.rl.offline import OfflineData


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.min_q_weight = 5.0
        self.num_penalty_actions = 4  # random + policy samples each
        # offline input (same contract as BCConfig.offline_data)
        self.input_ = None
        self.input_format = "parquet"
        self.updates_per_iteration = 20
        self.num_steps_sampled_before_learning_starts = 0

    def offline_data(self, *, input_=None, input_format=None,
                     updates_per_iteration=None) -> "CQLConfig":
        if input_ is not None:
            self.input_ = input_
        if input_format is not None:
            self.input_format = input_format
        if updates_per_iteration is not None:
            self.updates_per_iteration = updates_per_iteration
        return self


class CQLLearner(SACLearner):
    def _draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """SAC's noise, then the penalty's: uniform actions over the action
        range (n, B, A), and the policy samples' normals (n, B, A)."""
        noise = super()._draw_noise(batch_size)
        n, a = self.config.num_penalty_actions, self.module.action_dim
        scale = getattr(self.module, "action_scale", 1.0)
        noise["rand"] = (torch.rand((n, batch_size, a), generator=self._generator,
                                    device=self.device) * (2 * scale) - scale)
        noise["pi"] = torch.randn((n, batch_size, a), generator=self._generator,
                                  device=self.device)
        return noise

    def critic_penalty(self, obs, actions, dist_inputs, noise) -> Any:
        """CQL(H): E_s[logsumexp_a Q(s,a)] - E_(s,a)~D[Q(s,a)], both critics.

        Out-of-distribution actions = uniform random over the action range
        plus fresh policy samples (importance-corrected as in the paper's
        implementation)."""
        cfg, m = self.config, self.module
        dist = m.action_dist
        n = cfg.num_penalty_actions
        B = obs.shape[0]
        scale = getattr(m, "action_scale", 1.0)
        rand_logp = torch.full((n, B), -m.action_dim * math.log(2.0 * scale),
                               device=obs.device)
        pi_samples = [dist.sample_with_logp(noise["pi"][i], dist_inputs)
                      for i in range(n)]
        all_acts = torch.cat([noise["rand"],
                              torch.stack([a for a, _ in pi_samples])])  # (2n, B, A)
        all_logp = torch.cat([rand_logp,
                              torch.stack([lp for _, lp in pi_samples])]).detach()
        obs_all = obs.float().unsqueeze(0).expand(2 * n, *obs.shape)

        def penalty_for(q_net):
            q = m.q_values(q_net, obs_all, all_acts)
            # Importance correction: logsumexp over proposals q - logp.
            ood = torch.logsumexp(q - all_logp, dim=0)
            data_q = m.q_values(q_net, obs, actions)
            return ood.mean() - data_q.mean()

        return cfg.min_q_weight * (penalty_for(m.q1) + penalty_for(m.q2))


class CQL(SAC):
    """Offline: the replay buffer is replaced by the recorded dataset."""

    learner_class = CQLLearner
    config_class = CQLConfig

    def setup(self, config) -> None:
        super().setup(config)
        cfg = self.algo_config
        if cfg.input_ is None:
            raise ValueError("offline algorithms need .offline_data(input_=...)")
        self.offline = OfflineData(cfg.input_, format=cfg.input_format,
                                   seed=cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        results: Dict[str, Any] = {}
        for _ in range(max(1, cfg.updates_per_iteration)):
            batch = self.offline.sample(cfg.train_batch_size)
            results = self.learner_group.update_from_batch(batch)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return {"learners": results, "dataset_size": self.offline.size}
