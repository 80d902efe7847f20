"""Pendulum-v1 without gymnasium.

The port's stand-in for ``gymnasium.make("Pendulum-v1")``
(``gymnasium/envs/classic_control/pendulum.py`` under ``gym.make``'s
200-step ``TimeLimit``), which SAC and CQL run on; the card's machine has no
gymnasium. ``tests/test_torch_rl_env.py`` holds it to gymnasium's bit for
bit.

- Reset: the state ``(theta, thetadot)`` uniform in ``[-pi, pi] x [-1, 1]``
  from the env's generator (seeded as ``cartpole.py``'s is).
- Step: the action clipped to +-2 and taken as a scalar (its first entry);
  the cost ``angle_normalize(th)**2 + .1*thdot**2 + .001*u**2`` on the
  state before the step; ``newthdot`` clipped to +-8, then
  ``newth = th + newthdot*dt``. The expressions and their dtypes are
  gymnasium's, so a float32 action rounds where it rounds there.
- Observation: float32 ``[cos th, sin th, thdot]``; reward ``-cost``;
  never terminated, truncated at ``max_episode_steps`` (200).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.env.spaces import Box, np_random

DEFAULT_X = np.pi
DEFAULT_Y = 1.0


def angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class PendulumEnv:
    """gymnasium's ``Pendulum-v1`` under ``gym.make`` (ref: gymnasium/envs/
    classic_control/pendulum.py PendulumEnv)."""

    def __init__(self, g: float = 10.0, max_episode_steps: int = 200):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0  # noqa: E741 — gymnasium's name
        self.max_episode_steps = max_episode_steps
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(low=-self.max_torque, high=self.max_torque,
                                shape=(1,), dtype=np.float32)
        self.observation_space = Box(low=-high, high=high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state: Optional[np.ndarray] = None
        self._elapsed_steps: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict[str, Any]] = None
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None or self.np_random is None:
            self.np_random = np_random(seed)
        if options is None:
            high = np.array([DEFAULT_X, DEFAULT_Y])
        else:
            high = np.array([float(options.get("x_init", DEFAULT_X)),
                             float(options.get("y_init", DEFAULT_Y))])
        self.state = self.np_random.uniform(low=-high, high=high)
        self._elapsed_steps = 0
        return self._get_obs(), {}

    def step(self, u) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        if self.state is None:
            raise RuntimeError("Call reset before using step method.")
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt  # noqa: E741
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= self.max_episode_steps
        return self._get_obs(), -costs, False, truncated, {}

    def _get_obs(self) -> np.ndarray:
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)

    def close(self) -> None:
        pass
