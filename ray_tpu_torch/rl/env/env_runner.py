"""SingleAgentEnvRunner — vectorized env sampling with RLModule inference.

The port of ``ray_tpu/rl/env/env_runner.py`` (ref: rllib/env/
single_agent_env_runner.py:64 SingleAgentEnvRunner — vector env step loop
driving RLModule.forward_exploration; sample(num_timesteps | num_episodes),
get_state/set_state weight sync).

The policy forward over all envs' observations is ONE batched call on the
runner's device per vector step (observations stacked on the host), and
actions and log-probs come back to the host in one copy. The sampling
noise comes from an explicit ``torch.Generator`` on the host, one uniform
per logit and step copied to the device with the observations' batch: a
seed then draws the same numbers on the card as on the CPU, so the card's
sampler is checked against the CPU's step for step (``chip_smoke.py``'s
``rl_ppo_b``), not only in distribution. Envs are stepped with
immediate-reset semantics. A string env is made by ``rl/env/cartpole.py``'s
``make`` (the port carries its own CartPole-v1; gymnasium is not needed),
a callable as ``env(env_config)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rl.core.rl_module import Columns, RLModuleSpec
from ray_tpu_torch.rl.env import cartpole
from ray_tpu_torch.rl.env.episode import SingleAgentEpisode


def _make_env(env: Union[str, Callable], env_config: Dict[str, Any]):
    if callable(env):
        return env(env_config)
    return cartpole.make(env, **env_config)


def env_spaces(env: Union[str, Callable], env_config: Dict[str, Any]):
    """(obs_dim, action_dim, discrete) probed from one throwaway env. A
    discrete action space is one with ``n`` (the port's ``Discrete`` and
    gymnasium's alike)."""
    e = _make_env(env, env_config)
    try:
        obs_dim = int(np.prod(e.observation_space.shape))
        if hasattr(e.action_space, "n"):
            return obs_dim, int(e.action_space.n), True
        return obs_dim, int(np.prod(e.action_space.shape)), False
    finally:
        e.close()


class SingleAgentEnvRunner:
    """Runs num_envs envs; one policy call on ``device`` per vector step."""

    def __init__(self, *, env: Union[str, Callable],
                 env_config: Optional[Dict[str, Any]] = None,
                 module_spec: RLModuleSpec,
                 num_envs: int = 1,
                 rollout_fragment_length: int = 200,
                 explore: bool = True,
                 seed: int = 0,
                 worker_index: int = 0,
                 device: DeviceLike = None):
        self.env_config = dict(env_config or {})
        self.num_envs = num_envs
        self.rollout_fragment_length = rollout_fragment_length
        self.explore = explore
        self.worker_index = worker_index
        self.device = resolve_device(device)
        self.module = module_spec.build(seed=seed * 1000 + worker_index,
                                        device=self.device)
        self.module.requires_grad_(False)
        self._generator = torch.Generator().manual_seed(
            seed * 7919 + worker_index + 1)
        self._weights_seq = 0

        self.envs = [_make_env(env, self.env_config) for _ in range(num_envs)]
        self.episodes: List[SingleAgentEpisode] = []
        self._done_episode_returns: List[float] = []
        self._done_episode_lens: List[int] = []
        for i, e in enumerate(self.envs):
            obs, _ = e.reset(seed=seed * 100003 + worker_index * 1000 + i)
            ep = SingleAgentEpisode()
            ep.add_env_reset(np.asarray(obs, np.float32).ravel())
            self.episodes.append(ep)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _policy_step(self, obs: np.ndarray, explore: bool):
        """Actions and their log-probs for a (num_envs, obs_dim) batch:
        one forward on the device, one copy back."""
        dist = self.module.action_dist
        x = torch.from_numpy(obs).to(self.device)
        if explore:
            inputs = self.module.forward_exploration(x)[Columns.ACTION_DIST_INPUTS]
            actions = dist.sample(self._generator, inputs)
        else:
            inputs = self.module.forward_inference(x)[Columns.ACTION_DIST_INPUTS]
            actions = dist.deterministic(inputs)
        logp = dist.logp(inputs, actions)
        n = len(obs)
        host = torch.cat([actions.reshape(n, -1).to(logp.dtype),
                          logp.reshape(n, 1)], dim=1).cpu().numpy()
        if self.module.discrete:
            acts = host[:, 0].astype(np.int64)
        else:
            acts = host[:, :-1].reshape(actions.shape)
        return acts, host[:, -1]

    def sample(self, *, num_timesteps: Optional[int] = None,
               num_episodes: Optional[int] = None,
               random_actions: bool = False,
               explore: Optional[bool] = None) -> List[SingleAgentEpisode]:
        """Collect fragments totalling num_timesteps (across the vector), or
        num_episodes full episodes (ref: single_agent_env_runner.py sample())."""
        if num_timesteps is None and num_episodes is None:
            num_timesteps = self.rollout_fragment_length * self.num_envs
        explore = self.explore if explore is None else explore

        out: List[SingleAgentEpisode] = []
        steps = 0
        episodes_done = 0
        while True:
            obs = np.stack([ep.observations[-1] for ep in self.episodes])
            if random_actions:
                actions, logps = self._random_actions(obs)
            else:
                actions, logps = self._policy_step(obs, explore)

            for i, env in enumerate(self.envs):
                act = actions[i]
                if self.module.discrete:
                    act = int(act)
                next_obs, reward, terminated, truncated, _ = env.step(act)
                ep = self.episodes[i]
                ep.add_env_step(
                    np.asarray(next_obs, np.float32).ravel(), actions[i], reward,
                    terminated=terminated, truncated=truncated,
                    extra={Columns.ACTION_LOGP: float(logps[i])},
                )
                steps += 1
                if ep.is_done:
                    episodes_done += 1
                    self._done_episode_returns.append(ep.total_return)
                    self._done_episode_lens.append(ep.total_len)
                    out.append(ep)
                    reset_obs, _ = env.reset()
                    new_ep = SingleAgentEpisode()
                    new_ep.add_env_reset(np.asarray(reset_obs, np.float32).ravel())
                    self.episodes[i] = new_ep
            if num_episodes is not None:
                if episodes_done >= num_episodes:
                    break
            elif steps >= num_timesteps:
                break

        if num_episodes is None:
            # Hand off in-progress fragments too (PPO-style fixed batch).
            for i, ep in enumerate(self.episodes):
                if len(ep) > 0:
                    out.append(ep)
                    self.episodes[i] = ep.cut()
        return out

    def _random_actions(self, obs):
        n = len(self.envs)
        if self.module.discrete:
            acts = np.array([e.action_space.sample() for e in self.envs])
            logps = np.full((n,), -np.log(self.module.action_dim), np.float32)
        else:
            acts = np.stack([e.action_space.sample() for e in self.envs])
            logps = np.zeros((n,), np.float32)
        return acts, logps

    # ------------------------------------------------------------------
    def get_metrics(self) -> Dict[str, Any]:
        """Drain per-episode stats (ref: env runner metrics via MetricsLogger)."""
        returns, lens = self._done_episode_returns, self._done_episode_lens
        self._done_episode_returns, self._done_episode_lens = [], []
        if not returns:
            return {"num_episodes": 0}
        return {
            "num_episodes": len(returns),
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_max": float(np.max(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_len_mean": float(np.mean(lens)),
        }

    def reset(self) -> None:
        """Reset all envs and discard in-progress episodes (used between
        evaluation rounds so no trajectory spans two policies)."""
        for i, env in enumerate(self.envs):
            obs, _ = env.reset()
            ep = SingleAgentEpisode()
            ep.add_env_reset(np.asarray(obs, np.float32).ravel())
            self.episodes[i] = ep
        self._done_episode_returns, self._done_episode_lens = [], []

    def get_state(self) -> Dict[str, Any]:
        return {"params": {k: v.detach().clone()
                           for k, v in self.module.state_dict().items()},
                "weights_seq": self._weights_seq}

    def set_state(self, state: Dict[str, Any]) -> None:
        if "params" in state:
            # load_state_dict copies each tensor into this runner's own
            # parameters on its device: the learner's optimizer updates its
            # tensors in place, so holding them would sample with the
            # weights of later steps.
            self.module.load_state_dict(state["params"])
        self._weights_seq = state.get("weights_seq", self._weights_seq + 1)

    def ping(self) -> str:
        return "pong"

    def stop(self) -> None:
        for e in self.envs:
            e.close()
