"""MultiAgentEnvRunner — samples a MultiAgentEnv with per-module inference.

The port of ``ray_tpu/rl/env/multi_agent_env_runner.py`` (ref: rllib/env/
multi_agent_env_runner.py MultiAgentEnvRunner — steps the env with a
MultiRLModule, routing each agent's observation through its mapped module
via the policy_mapping_fn).

Agents are grouped by module each step, so the device work is one batched
forward per module per step, on the runner's device, and one copy back.
The sampling noise comes from one host ``torch.Generator`` per runner
(seeded ``seed * 7919 + worker_index + 1``, where the reference seeds its
JAX key), drawn module after module in the order the agents first appear.
Weights are copied into the runner's own modules on receipt: the learners'
optimizers update their tensors in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rl.core.multi_rl_module import MultiRLModuleSpec
from ray_tpu_torch.rl.core.rl_module import Columns
from ray_tpu_torch.rl.env.multi_agent_episode import MultiAgentEpisode


class MultiAgentEnvRunner:
    def __init__(self, *, env: Union[type, Callable],
                 env_config: Optional[Dict[str, Any]] = None,
                 module_spec: MultiRLModuleSpec,
                 policy_mapping_fn: Callable[[str], str],
                 rollout_fragment_length: int = 200,
                 explore: bool = True,
                 seed: int = 0,
                 worker_index: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.env = env(env_config or {}) if callable(env) else env
        self.module = module_spec.build(seed=seed * 1000 + worker_index,
                                        device=self.device)
        self.module.requires_grad_(False)
        self.policy_mapping_fn = policy_mapping_fn
        self.rollout_fragment_length = rollout_fragment_length
        self.explore = explore
        self._generator = torch.Generator().manual_seed(
            seed * 7919 + worker_index + 1)
        self._episode: Optional[MultiAgentEpisode] = None
        self._obs: Dict[str, Any] = {}
        self._done_returns: List[float] = []
        self._done_lens: List[int] = []
        self._reset_env(seed)

    # ------------------------------------------------------------------
    def _reset_env(self, seed: Optional[int] = None) -> None:
        obs, _ = self.env.reset(seed=seed)
        mapping = {a: self.policy_mapping_fn(a) for a in obs}
        self._episode = MultiAgentEpisode(agent_to_module=mapping)
        self._episode.add_env_reset(obs)
        self._obs = obs

    def sample(self, *, num_timesteps: Optional[int] = None,
               num_episodes: Optional[int] = None,
               random_actions: bool = False,
               explore: Optional[bool] = None) -> List[MultiAgentEpisode]:
        explore = self.explore if explore is None else explore
        if num_timesteps is None and num_episodes is None:
            num_timesteps = self.rollout_fragment_length
        out: List[MultiAgentEpisode] = []
        env_steps = 0
        episodes_done = 0
        while True:
            actions, extras = self._compute_actions(
                self._obs, random_actions, explore)
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            self._episode.add_env_step(
                obs, actions, rewards, terminateds=terms, truncateds=truncs,
                extras=extras)
            env_steps += 1
            # Late joiners need a module assignment before they first act.
            for a in obs:
                if a not in self._episode.agent_to_module:
                    self._episode.agent_to_module[a] = self.policy_mapping_fn(a)
            # The next step acts only for agents still alive with an obs.
            self._obs = {a: o for a, o in obs.items()
                         if not (terms.get(a) or truncs.get(a))}
            if self._episode.is_done or not self._obs:
                episodes_done += 1
                self._done_returns.append(self._episode.total_return)
                self._done_lens.append(len(self._episode))
                out.append(self._episode)
                self._reset_env()
            if num_episodes is not None:
                if episodes_done >= num_episodes:
                    break
            elif env_steps >= num_timesteps:
                break
        if num_episodes is None and len(self._episode) > 0:
            # Hand off the in-progress fragment; continue from the last obs.
            out.append(self._episode)
            cut = MultiAgentEpisode(
                agent_to_module=dict(self._episode.agent_to_module))
            for agent, ep in self._episode.agent_episodes.items():
                if not ep.is_done:
                    cut.agent_episodes[agent] = ep.cut()
            self._episode = cut
        return out

    @torch.no_grad()
    def _compute_actions(self, obs: Dict[str, Any], random_actions: bool,
                         explore: bool):
        actions: Dict[str, Any] = {}
        extras: Dict[str, Dict[str, Any]] = {}
        if not obs:
            return actions, extras
        if random_actions:
            for a in obs:
                actions[a] = self.env.action_spaces[a].sample()
                extras[a] = {Columns.ACTION_LOGP: 0.0}
            return actions, extras
        # Group agents by module: one batched forward per module.
        by_module: Dict[str, List[str]] = {}
        for a in obs:
            by_module.setdefault(
                self._episode.agent_to_module.get(
                    a, self.policy_mapping_fn(a)), []).append(a)
        for mid, agents in by_module.items():
            batch = np.stack([np.asarray(obs[a], np.float32).ravel()
                              for a in agents])
            mod = self.module[mid]
            dist = mod.action_dist
            x = torch.from_numpy(batch).to(self.device)
            if explore:
                inputs = mod.forward_exploration(x)[Columns.ACTION_DIST_INPUTS]
                acts = dist.sample(self._generator, inputs)
            else:
                inputs = mod.forward_inference(x)[Columns.ACTION_DIST_INPUTS]
                acts = dist.deterministic(inputs)
            logps = dist.logp(inputs, acts)
            n = len(agents)
            host = torch.cat([acts.reshape(n, -1).to(logps.dtype),
                              logps.reshape(n, 1)], dim=1).cpu().numpy()
            for i, a in enumerate(agents):
                actions[a] = (int(host[i, 0]) if mod.discrete
                              else host[i, :-1].reshape(acts.shape[1:]))
                extras[a] = {Columns.ACTION_LOGP: float(host[i, -1])}
        return actions, extras

    # ------------------------------------------------------------------
    def get_metrics(self) -> Dict[str, Any]:
        returns, lens = self._done_returns, self._done_lens
        self._done_returns, self._done_lens = [], []
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
        self._reset_env()
        self._done_returns, self._done_lens = [], []

    def get_state(self) -> Dict[str, Any]:
        return {"params": {mid: {k: v.detach().clone()
                                 for k, v in m.state_dict().items()}
                           for mid, m in self.module.items()}}

    def set_state(self, state: Dict[str, Any]) -> None:
        if "params" in state:
            # load_state_dict copies into this runner's own tensors: the
            # learners' optimizers update theirs in place.
            for mid, params in state["params"].items():
                self.module[mid].load_state_dict(params)

    def ping(self) -> str:
        return "pong"

    def stop(self) -> None:
        self.env.close()
