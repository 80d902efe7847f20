"""SingleAgentEpisode — trajectory container.

(ref: rllib/env/single_agent_episode.py SingleAgentEpisode — observations
have len T+1, actions/rewards len T; cut()/finalize() for fragment handoff.)
A copy of ``ray_tpu/rl/env/episode.py``.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

import numpy as np


class SingleAgentEpisode:
    def __init__(self, id_: Optional[str] = None,
                 observations: Optional[List[Any]] = None):
        self.id_ = id_ or uuid.uuid4().hex[:16]
        self.observations: List[Any] = list(observations or [])
        self.actions: List[Any] = []
        self.rewards: List[float] = []
        self.extra: Dict[str, List[Any]] = {}  # e.g. action_logp per step
        self.is_terminated = False
        self.is_truncated = False
        #: return accumulated across previous fragments of the same episode
        #: (an episode cut at a rollout-fragment boundary continues in the
        #: next fragment with the same id).
        self._prev_return = 0.0
        self._prev_len = 0

    # ------------------------------------------------------------------
    def add_env_reset(self, observation) -> None:
        self.observations.append(observation)

    def add_env_step(self, observation, action, reward, *, terminated=False,
                     truncated=False, extra: Optional[Dict[str, Any]] = None) -> None:
        assert not self.is_done, "cannot extend a finished episode"
        self.observations.append(observation)
        self.actions.append(action)
        self.rewards.append(float(reward))
        if extra:
            for k, v in extra.items():
                self.extra.setdefault(k, []).append(v)
        self.is_terminated = bool(terminated)
        self.is_truncated = bool(truncated)

    # ------------------------------------------------------------------
    @property
    def is_done(self) -> bool:
        return self.is_terminated or self.is_truncated

    def __len__(self) -> int:
        return len(self.actions)

    @property
    def total_len(self) -> int:
        return self._prev_len + len(self)

    def get_return(self) -> float:
        return float(sum(self.rewards))

    @property
    def total_return(self) -> float:
        return self._prev_return + self.get_return()

    def cut(self) -> "SingleAgentEpisode":
        """Chop at the current step: self becomes the finished fragment, the
        returned successor continues the episode from the last observation
        (ref: single_agent_episode.py cut())."""
        successor = SingleAgentEpisode(id_=self.id_,
                                       observations=[self.observations[-1]])
        successor._prev_return = self.total_return
        successor._prev_len = self.total_len
        return successor

    # ------------------------------------------------------------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        out = {
            "obs": np.asarray(self.observations, np.float32),  # (T+1, ...)
            "actions": np.asarray(self.actions),
            "rewards": np.asarray(self.rewards, np.float32),
        }
        for k, v in self.extra.items():
            out[k] = np.asarray(v)
        return out

    def __repr__(self) -> str:
        return (f"SingleAgentEpisode(id={self.id_}, len={len(self)}, "
                f"return={self.get_return():.1f}, done={self.is_done})")
