"""DQN — double-Q with a target network and (prioritized) replay.

The port of ``ray_tpu/rl/algorithms/dqn.py`` (ref: rllib/algorithms/dqn/
dqn.py DQNConfig/DQN; loss in rllib/algorithms/dqn/torch/
dqn_torch_learner.py — double-Q TD target, Huber loss; target net sync every
target_network_update_freq steps).

The target network (``DefaultQModule.target_q``) is a separate set of
tensors that takes no gradient and is in no optimizer: a hard sync copies
the online weights into it (``copy_``), a soft one averages them in place.
The TD target is computed under ``no_grad``, as the reference's
``stop_gradient`` does. The epsilon draw stays on numpy's global state, as
the reference's does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.connectors import episodes_to_transitions
from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.rl_module import Columns, DefaultQModule
from ray_tpu_torch.rl.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                   ReplayBuffer)


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.module_class = DefaultQModule
        self.lr = 5e-4
        self.train_batch_size = 32
        self.num_epochs = 1
        self.minibatch_size = None
        self.rollout_fragment_length = 4
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = False
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # in learner update steps
        self.n_step = 1
        self.double_q = True
        self.epsilon = [(0, 1.0), (10000, 0.05)]  # piecewise-linear schedule
        self.tau = 1.0  # 1.0 = hard target sync


class DQNLearner(TorchLearner):
    def _q_and_target(self, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Q of the taken actions, and the TD target (no gradient)."""
        cfg = self.config
        q_all = self.module.forward_train(batch[Columns.OBS])["q_values"]
        q_taken = q_all.gather(
            -1, batch[Columns.ACTIONS].long().unsqueeze(-1)).squeeze(-1)
        with torch.no_grad():
            q_next_target = self.module.forward_target(batch[Columns.NEXT_OBS])
            if cfg.double_q:
                # Online net picks the argmax; target net evaluates it.
                q_next_online = self.module.forward_train(
                    batch[Columns.NEXT_OBS])["q_values"]
                best = torch.argmax(q_next_online, dim=-1)
                q_next = q_next_target.gather(-1, best.unsqueeze(-1)).squeeze(-1)
            else:
                q_next = q_next_target.max(dim=-1).values
            target = (batch[Columns.REWARDS]
                      + (cfg.gamma ** cfg.n_step)
                      * (1.0 - batch[Columns.TERMINATEDS]) * q_next)
        return q_taken, target

    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        q_taken, target = self._q_and_target(batch)
        td = q_taken - target
        huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        weights = batch.get(Columns.WEIGHTS)
        loss = (huber * weights).mean() if weights is not None else huber.mean()
        return loss, {"td_error_mean": td.abs().mean(),
                      "q_mean": q_taken.mean()}

    @torch.no_grad()
    def compute_td_errors(self, batch: Dict[str, Any]) -> np.ndarray:
        """Per-sample |TD| for prioritized-replay updates (ref: PER priority
        refresh after each train batch)."""
        rows = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items() if k != Columns.WEIGHTS}
        q_taken, target = self._q_and_target(rows)
        return (q_taken - target).abs().cpu().numpy()

    @torch.no_grad()
    def after_update(self, metrics: Dict[str, Any]) -> None:
        cfg = self.config
        if self._steps % max(1, cfg.target_network_update_freq) == 0:
            tau = cfg.tau
            for t, o in zip(self.module.target_q.parameters(),
                            self.module.q.parameters()):
                if tau >= 1.0:
                    t.copy_(o)
                else:
                    t.copy_((1 - tau) * t + tau * o)


class DQN(Algorithm):
    learner_class = DQNLearner
    config_class = DQNConfig

    def setup(self, config) -> None:
        super().setup(config)
        cfg = self.algo_config
        self.replay = (PrioritizedReplayBuffer(cfg.replay_buffer_capacity,
                                               seed=cfg.seed)
                       if cfg.prioritized_replay
                       else ReplayBuffer(cfg.replay_buffer_capacity,
                                         seed=cfg.seed))

    def _epsilon(self) -> float:
        """Piecewise-linear interpolation across ALL schedule breakpoints."""
        sched = self.algo_config.epsilon
        t = self._lifetime_steps
        if t <= sched[0][0]:
            return sched[0][1]
        for (t0, e0), (t1, e1) in zip(sched, sched[1:]):
            if t <= t1:
                return e0 + (e1 - e0) * (t - t0) / max(1, t1 - t0)
        return sched[-1][1]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        warmup = (self._lifetime_steps
                  < cfg.num_steps_sampled_before_learning_starts)
        # Epsilon-greedy: with prob eps sample random actions for the whole
        # fragment (fragments are short — 4 steps default); the other arm is
        # GREEDY argmax over Q (explore=False), not Boltzmann sampling.
        explore_random = warmup or (np.random.random() < self._epsilon())
        episodes = self.env_runner_group.sample(
            num_timesteps=max(cfg.rollout_fragment_length,
                              cfg.train_batch_size if warmup else 0)
            or cfg.rollout_fragment_length,
            random_actions=explore_random, explore=False)
        self._lifetime_steps += sum(len(ep) for ep in episodes)
        self.replay.add(episodes_to_transitions(episodes))
        if warmup or len(self.replay) < cfg.train_batch_size:
            return {"learners": {}, "epsilon": self._epsilon()}
        batch = self.replay.sample(cfg.train_batch_size)
        learner_results = self.learner_group.update_from_batch(batch)
        if cfg.prioritized_replay:
            td = self.learner_group.foreach_learner(
                "compute_td_errors", batch)[0]
            self.replay.update_priorities(td)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return {"learners": learner_results, "epsilon": self._epsilon(),
                "replay_size": len(self.replay)}
