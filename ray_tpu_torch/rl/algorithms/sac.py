"""SAC — soft actor-critic for continuous control.

The port of ``ray_tpu/rl/algorithms/sac.py`` (ref: rllib/algorithms/sac/
sac.py SACConfig/SAC; losses in rllib/algorithms/sac/torch/
sac_torch_learner.py — twin-Q TD target with entropy bonus, squashed-Gaussian
actor loss, auto-tuned temperature alpha; soft target sync with tau).

One update is three optimizer steps in the reference's order:

1. the critics step on a TD target that uses the *old* alpha and the target
   critics (``no_grad``); the actor's inputs on the batch's observations
   enter CQL's penalty as constants;
2. the actor steps on the *updated* critics, run with detached weights
   (``torch.func.functional_call``), so no gradient reaches them;
3. the temperature steps on the actor's ``new_logp`` (detached);
4. the target critics move by ``tau`` toward the new critics, in place.

Each section zeroes its own optimizer's gradients before its backward. The
target critics take no gradient and are in no optimizer (the reference's
Adam sees zero gradients for them, so its state for them stays zero). A
step's noise is drawn in one place, ``_draw_noise``, from the learner's
generator in a fixed order (the next actions', then the new actions'); the
parity tests replace that draw with the reference's own JAX draws.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.connectors import episodes_to_transitions
from ray_tpu_torch.rl.core.learner import TorchLearner, host_copy
from ray_tpu_torch.rl.core.rl_module import Columns, RLModule, _generator, _MLP
from ray_tpu_torch.rl.utils.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SquashedGaussian:
    """tanh-squashed Gaussian scaled to the action range (ref: rllib/models/
    torch/torch_distributions.py TorchSquashedGaussian). Instance-based
    because the action scale is part of the distribution."""

    def __init__(self, scale: float = 1.0):
        self.scale = scale

    def _split(self, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = inputs.chunk(2, dim=-1)
        return mean, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)

    def sample(self, generator: torch.Generator, inputs: torch.Tensor) -> torch.Tensor:
        """Actions with normal noise from ``generator`` on its own device,
        moved to the inputs' (the env runners' path)."""
        mean, log_std = self._split(inputs)
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=generator.device).to(mean.device)
        return torch.tanh(mean + torch.exp(log_std) * noise) * self.scale

    def sample_with_logp(self, noise: torch.Tensor, inputs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(action, logp) for the standard-normal ``noise`` — the learner's
        path."""
        mean, log_std = self._split(inputs)
        pre = mean + torch.exp(log_std) * noise
        act = torch.tanh(pre)
        return act * self.scale, self._logp_pre(inputs, pre, act)

    def _logp_pre(self, inputs, pre, tanh_pre) -> torch.Tensor:
        mean, log_std = self._split(inputs)
        var = torch.exp(2 * log_std)
        base = -0.5 * ((pre - mean) ** 2 / var + 2 * log_std
                       + math.log(2 * math.pi))
        # tanh change-of-variables + the constant scale factor.
        correction = torch.log(1.0 - tanh_pre ** 2 + 1e-6) + math.log(self.scale)
        return (base - correction).sum(dim=-1)

    def logp(self, inputs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        squashed = torch.clamp(actions / self.scale, -1.0 + 1e-6, 1.0 - 1e-6)
        return self._logp_pre(inputs, torch.atanh(squashed), squashed)

    def entropy(self, inputs: torch.Tensor) -> torch.Tensor:
        # No closed form for the squashed distribution; the Gaussian entropy
        # is the standard surrogate (alpha auto-tuning uses -logp anyway).
        _, log_std = self._split(inputs)
        return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(dim=-1)

    def deterministic(self, inputs: torch.Tensor) -> torch.Tensor:
        mean, _ = self._split(inputs)
        return torch.tanh(mean) * self.scale


class SACModule(RLModule):
    """Squashed-Gaussian actor + twin Q critics (+ target copies) and the
    temperature ``log_alpha`` (ref: rllib/algorithms/sac/
    default_sac_rl_module.py). Parameter names are the reference's tree:
    ``pi``, ``q1``, ``q2``, ``target_q1``, ``target_q2``, ``log_alpha``."""

    def __init__(self, observation_dim, action_dim, discrete=False,
                 hiddens=(256, 256), action_scale: float = 1.0, seed: int = 0,
                 **kw):
        if discrete:
            raise ValueError("SAC is a continuous-control algorithm")
        super().__init__(observation_dim, action_dim, discrete,
                         hiddens=tuple(hiddens), action_scale=action_scale,
                         **kw)
        self.hiddens = tuple(hiddens)
        self.action_scale = action_scale
        sa_dim = observation_dim + action_dim
        self.pi = _MLP(self.hiddens, 2 * action_dim, observation_dim,
                       out_scale=0.01)
        self.q1 = _MLP(self.hiddens, 1, sa_dim, out_scale=1.0)
        self.q2 = _MLP(self.hiddens, 1, sa_dim, out_scale=1.0)
        self.target_q1 = _MLP(self.hiddens, 1, sa_dim, out_scale=1.0)
        self.target_q2 = _MLP(self.hiddens, 1, sa_dim, out_scale=1.0)
        self.target_q1.requires_grad_(False)
        self.target_q2.requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.zeros(()))
        self.init_params(_generator(seed))

    def init_params(self, generator: torch.Generator) -> None:
        self.pi.init(generator)
        self.q1.init(generator)
        self.q2.init(generator)
        self.target_q1.load_state_dict(self.q1.state_dict())
        self.target_q2.load_state_dict(self.q2.state_dict())
        with torch.no_grad():
            self.log_alpha.zero_()

    @property
    def action_dist(self):
        return SquashedGaussian(self.action_scale)

    def forward_train(self, obs) -> Dict[str, torch.Tensor]:
        return {Columns.ACTION_DIST_INPUTS: self.pi(self._obs(obs))}

    forward_exploration = forward_train
    forward_inference = forward_train

    def q_values(self, q_net: nn.Module, obs: torch.Tensor,
                 actions: torch.Tensor, frozen: bool = False) -> torch.Tensor:
        """Q(s, a) of one critic; ``frozen`` runs it with detached weights,
        so a backward reaches the actions and not the critic."""
        sa = torch.cat([obs.float(), actions.float()], dim=-1)
        if frozen:
            return functional_call(
                q_net, {k: v.detach() for k, v in q_net.named_parameters()},
                (sa,))[..., 0]
        return q_net(sa)[..., 0]


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.module_class = SACModule
        self.lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.train_batch_size = 256
        self.num_epochs = 1
        self.minibatch_size = None
        self.rollout_fragment_length = 1
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.tau = 0.005  # soft target sync every update
        self.target_entropy: Any = "auto"  # auto => -action_dim
        self.initial_alpha = 1.0
        self.n_step = 1
        self.updates_per_step = 1


class SACLearner(TorchLearner):
    """Three optimizers (actor, both critics, temperature) and the update
    order of the module docstring; overrides the base single-loss step."""

    def __init__(self, **kw):
        super().__init__(**kw)
        if self.world_size > 1:
            # The three-optimizer step has no gradient all-reduce: several
            # learners would each update on their own shard and diverge.
            raise NotImplementedError(
                "SAC/CQL multi-learner gradient sync is not implemented; "
                "use num_learners<=1 (PPO/DQN/IMPALA support learner groups)")
        cfg = self.config
        self._target_entropy = (
            -float(self.module.action_dim)
            if cfg.target_entropy == "auto" else float(cfg.target_entropy))
        with torch.no_grad():
            self.module.log_alpha.fill_(float(np.float32(np.log(cfg.initial_alpha))))

    def configure_optimizer(self) -> None:
        """The section optimizers (ref: sac.py optimizer per network);
        ``self.optimizer`` stays None."""
        cfg, m = self.config, self.module
        self.optimizers = {
            "pi": torch.optim.Adam(m.pi.parameters(), lr=cfg.lr),
            "q": torch.optim.Adam([*m.q1.parameters(), *m.q2.parameters()],
                                  lr=cfg.critic_lr),
            "alpha": torch.optim.Adam([m.log_alpha], lr=cfg.alpha_lr),
        }
        return None

    def _draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """One step's standard-normal noise, in order: the next actions',
        the new actions'."""
        shape = (batch_size, self.module.action_dim)
        return {k: torch.randn(shape, generator=self._generator,
                               device=self.device) for k in ("next", "new")}

    def critic_penalty(self, obs, actions, dist_inputs, noise) -> Any:
        """Extra critic loss term; CQL overrides with its conservative
        regularizer."""
        return 0.0

    def _update(self, mb: Dict[str, torch.Tensor]
                ) -> Tuple[List[str], torch.Tensor]:
        cfg, m = self.config, self.module
        dist = m.action_dist
        opt = self.optimizers
        obs, actions = mb[Columns.OBS], mb[Columns.ACTIONS]
        noise = self._draw_noise(obs.shape[0])
        alpha = torch.exp(m.log_alpha.detach())  # the old alpha, a copy

        # ---- critic update (twin Q, entropy-regularized TD target) ----
        with torch.no_grad():
            next_obs = mb[Columns.NEXT_OBS]
            next_inputs = m.forward_train(next_obs)[Columns.ACTION_DIST_INPUTS]
            next_act, next_logp = dist.sample_with_logp(noise["next"], next_inputs)
            q_next = torch.minimum(m.q_values(m.target_q1, next_obs, next_act),
                                   m.q_values(m.target_q2, next_obs, next_act))
            target = (mb[Columns.REWARDS] + (cfg.gamma ** cfg.n_step)
                      * (1.0 - mb[Columns.TERMINATEDS])
                      * (q_next - alpha * next_logp))
            cur_inputs = m.forward_train(obs)[Columns.ACTION_DIST_INPUTS]
        opt["q"].zero_grad(set_to_none=True)
        q1 = m.q_values(m.q1, obs, actions)
        q2 = m.q_values(m.q2, obs, actions)
        critic_loss = (torch.mean((q1 - target) ** 2)
                       + torch.mean((q2 - target) ** 2)
                       + self.critic_penalty(obs, actions, cur_inputs, noise))
        critic_loss.backward()
        opt["q"].step()

        # ---- actor update (the UPDATED critics, frozen) ----
        opt["pi"].zero_grad(set_to_none=True)
        inputs = m.forward_train(obs)[Columns.ACTION_DIST_INPUTS]
        new_act, new_logp = dist.sample_with_logp(noise["new"], inputs)
        q_min = torch.minimum(m.q_values(m.q1, obs, new_act, frozen=True),
                              m.q_values(m.q2, obs, new_act, frozen=True))
        actor_loss = torch.mean(alpha * new_logp - q_min)
        actor_loss.backward()
        opt["pi"].step()

        # ---- temperature update (ref: sac.py target entropy loss) ----
        opt["alpha"].zero_grad(set_to_none=True)
        alpha_loss = -torch.mean(torch.exp(m.log_alpha)
                                 * (new_logp.detach() + self._target_entropy))
        alpha_loss.backward()
        opt["alpha"].step()

        # ---- soft target sync (every update, tau-averaged) ----
        with torch.no_grad():
            tau = cfg.tau
            for tgt, src in ((m.target_q1, m.q1), (m.target_q2, m.q2)):
                for t, o in zip(tgt.parameters(), src.parameters()):
                    t.copy_((1.0 - tau) * t + tau * o)
            critic_loss, actor_loss, alpha_loss = (
                critic_loss.detach(), actor_loss.detach(), alpha_loss.detach())
            values = torch.stack([
                critic_loss, actor_loss, alpha_loss, torch.exp(m.log_alpha),
                target.mean(), -new_logp.detach().mean(),
                critic_loss + actor_loss + alpha_loss])
        return ["critic_loss", "actor_loss", "alpha_loss", "alpha",
                "q_target_mean", "entropy_est", "total_loss"], values

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """Copies of the actor's tensors only (``pi.*``): the runners sample
        with the actor, and shipping the critics every sync wastes
        bandwidth."""
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()
                if k.startswith("pi.")}

    def get_state(self) -> Dict[str, Any]:
        return {"params": host_copy(self.module.state_dict()),
                "opt_state": {k: host_copy(o.state_dict())
                              for k, o in self.optimizers.items()},
                "steps": self._steps}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state["params"])
        for k, o in self.optimizers.items():
            o.load_state_dict(host_copy(state["opt_state"][k]))
        self._steps = state.get("steps", 0)


class SAC(Algorithm):
    learner_class = SACLearner
    config_class = SACConfig

    def setup(self, config) -> None:
        super().setup(config)
        self.replay = ReplayBuffer(self.algo_config.replay_buffer_capacity,
                                   seed=self.algo_config.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        warmup = (self._lifetime_steps
                  < cfg.num_steps_sampled_before_learning_starts)
        episodes = self.env_runner_group.sample(
            num_timesteps=(cfg.num_steps_sampled_before_learning_starts
                           if warmup else
                           cfg.rollout_fragment_length
                           * max(1, cfg.num_envs_per_env_runner)),
            random_actions=warmup)
        self._lifetime_steps += sum(len(ep) for ep in episodes)
        self.replay.add(episodes_to_transitions(episodes))
        if warmup or len(self.replay) < cfg.train_batch_size:
            return {"learners": {}, "replay_size": len(self.replay)}
        results: Dict[str, Any] = {}
        for _ in range(max(1, cfg.updates_per_step)):
            batch = self.replay.sample(cfg.train_batch_size)
            results = self.learner_group.update_from_batch(batch)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return {"learners": results, "replay_size": len(self.replay)}
