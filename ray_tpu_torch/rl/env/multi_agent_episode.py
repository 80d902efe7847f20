"""MultiAgentEpisode — per-agent trajectories under one env episode.

The port of ``ray_tpu/rl/env/multi_agent_episode.py`` (ref:
rllib/env/multi_agent_episode.py MultiAgentEpisode — maps agent ids to
their SingleAgentEpisode plus the agent→module assignment used to route
training data to the right policy). A copy of the reference's.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.rl.env.episode import SingleAgentEpisode


class MultiAgentEpisode:
    def __init__(self, agent_to_module: Optional[Dict[str, str]] = None,
                 id_: Optional[str] = None):
        self.id_ = id_ or uuid.uuid4().hex[:16]
        self.agent_episodes: Dict[str, SingleAgentEpisode] = {}
        self.agent_to_module: Dict[str, str] = dict(agent_to_module or {})
        self.is_terminated = False
        self.is_truncated = False

    # ------------------------------------------------------------------
    def add_env_reset(self, observations: Dict[str, Any]) -> None:
        for agent, obs in observations.items():
            ep = self.agent_episodes.setdefault(agent, SingleAgentEpisode())
            ep.add_env_reset(obs)

    def add_env_step(self, observations: Dict[str, Any],
                     actions: Dict[str, Any], rewards: Dict[str, float],
                     *, terminateds: Dict[str, bool],
                     truncateds: Dict[str, bool],
                     extras: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        for agent, action in actions.items():
            if agent not in observations:
                continue  # env dropped the agent without a final obs
            ep = self.agent_episodes.get(agent)
            if ep is None or ep.is_done or not ep.observations:
                continue
            ep.add_env_step(
                observations[agent], action, rewards.get(agent, 0.0),
                terminated=terminateds.get(agent, False),
                truncated=truncateds.get(agent, False),
                extra=(extras or {}).get(agent))
        # Agents may JOIN mid-episode (documented MultiAgentEnv contract):
        # their first observation opens a fresh per-agent trajectory.
        for agent, obs in observations.items():
            if agent not in self.agent_episodes:
                ep = SingleAgentEpisode()
                ep.add_env_reset(obs)
                self.agent_episodes[agent] = ep
        self.is_terminated = bool(terminateds.get("__all__", False))
        self.is_truncated = bool(truncateds.get("__all__", False))

    # ------------------------------------------------------------------
    @property
    def is_done(self) -> bool:
        return self.is_terminated or self.is_truncated

    def __len__(self) -> int:
        """Env steps ≈ max agent trajectory length."""
        return max((len(ep) for ep in self.agent_episodes.values()), default=0)

    @property
    def total_env_steps(self) -> int:
        return sum(len(ep) for ep in self.agent_episodes.values())

    @property
    def total_return(self) -> float:
        return float(sum(ep.total_return
                         for ep in self.agent_episodes.values()))

    def episodes_by_module(self) -> Dict[str, List[SingleAgentEpisode]]:
        """Route agent trajectories to their modules for training."""
        out: Dict[str, List[SingleAgentEpisode]] = {}
        for agent, ep in self.agent_episodes.items():
            if len(ep) == 0:
                continue
            module_id = self.agent_to_module.get(agent, "default_policy")
            out.setdefault(module_id, []).append(ep)
        return out

    def __repr__(self) -> str:
        return (f"MultiAgentEpisode(id={self.id_}, "
                f"agents={list(self.agent_episodes)}, "
                f"return={self.total_return:.1f}, done={self.is_done})")
