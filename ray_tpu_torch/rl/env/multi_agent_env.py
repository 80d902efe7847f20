"""MultiAgentEnv API and the MultiAgentCartPole example env.

The port of ``ray_tpu/rl/env/multi_agent_env.py`` (ref: rllib/env/
multi_agent_env.py MultiAgentEnv — reset() -> per-agent obs dict;
step(action_dict) -> per-agent obs/reward/terminated/truncated/info dicts
whose terminated/truncated dicts carry an "__all__" key; example env
rllib/examples/envs/classes/multi_agent.py MultiAgentCartPole).
``MultiAgentCartPole`` builds on the port's CartPole-v1 (``cartpole.py``),
not on ``gym.make``, with the same ``seed + i`` per agent.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.env import cartpole


class MultiAgentEnv:
    """Per-agent dict-in / dict-out environment.

    Agents may come and go between steps: only agents present in the
    returned observation dict act on the next step. ``terminateds`` /
    ``truncateds`` carry per-agent flags plus ``"__all__"``.
    """

    #: ids of agents that can ever appear (informational)
    possible_agents: Tuple[str, ...] = ()
    #: per-agent spaces (used to derive module specs)
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]) -> Tuple[
            Dict[str, Any], Dict[str, float], Dict[str, bool],
            Dict[str, bool], Dict[str, Any]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPole-v1 instances, one per agent.

    The episode ends (``__all__``) when every sub-episode has ended; an
    agent whose pole fell stops receiving observations while the others
    continue.
    """

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_agents = int(config.get("num_agents", 2))
        self.possible_agents = tuple(
            f"agent_{i}" for i in range(self.num_agents))
        self._envs = {a: cartpole.make("CartPole-v1")
                      for a in self.possible_agents}
        self.observation_spaces = {
            a: e.observation_space for a, e in self._envs.items()}
        self.action_spaces = {
            a: e.action_space for a, e in self._envs.items()}
        self._done: Dict[str, bool] = {}

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = {}, {}
        for i, (a, e) in enumerate(self._envs.items()):
            o, info = e.reset(seed=None if seed is None else seed + i)
            obs[a] = np.asarray(o, np.float32)
            infos[a] = info
            self._done[a] = False
        return obs, infos

    def step(self, action_dict):
        obs, rewards, terms, truncs, infos = {}, {}, {}, {}, {}
        for a, act in action_dict.items():
            if self._done.get(a, True):
                continue
            o, r, term, trunc, info = self._envs[a].step(int(act))
            # The final observation comes even on termination, so the
            # episode can close with its bootstrap obs.
            obs[a] = np.asarray(o, np.float32)
            rewards[a] = float(r)
            terms[a] = bool(term)
            truncs[a] = bool(trunc)
            infos[a] = info
            self._done[a] = bool(term or trunc)
        terms["__all__"] = all(self._done.values())
        truncs["__all__"] = False
        return obs, rewards, terms, truncs, infos

    def close(self) -> None:
        for e in self._envs.values():
            e.close()
