"""CartPole-v1 without gymnasium, and ``make``, the port's env registry.

The reference makes its envs with ``gymnasium.make`` (``ray_tpu/rl/env/
env_runner.py``) and tests action spaces against ``gymnasium.spaces``; the
card's machine has no gymnasium. This module is the port's stand-in: the
same dynamics, the same seeding and the same time limit as gymnasium's
``CartPole-v1`` (``gymnasium/envs/classic_control/cartpole.py`` under
``gym.make``'s ``TimeLimit``), step for step and bit for bit, which
``tests/test_torch_rl_env.py`` holds it to.

- Seeding: ``reset(seed=s)`` makes ``np.random.Generator(PCG64(
  SeedSequence(s)))``, as ``gymnasium.utils.seeding.np_random`` does;
  ``reset()`` without a seed goes on drawing from the same generator.
- State: float64, drawn uniform in [-0.05, 0.05); observations are its
  float32 copy.
- Step: Euler integration with numpy's ``cos``, ``sin`` and ``square`` on
  float64 scalars, terminated outside 2.4 of the centre or 12 degrees of
  the vertical, truncated at ``max_episode_steps`` (500) steps.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rl.env.pendulum import PendulumEnv
from ray_tpu_torch.rl.env.spaces import Box, Discrete, np_random  # noqa: F401


class CartPoleEnv:
    """gymnasium's ``CartPole-v1`` under ``gym.make`` (its 500-step
    ``TimeLimit`` included; ref: gymnasium/envs/classic_control/
    cartpole.py CartPoleEnv)."""

    def __init__(self, max_episode_steps: int = 500,
                 sutton_barto_reward: bool = False):
        self._sutton_barto_reward = sutton_barto_reward
        self.max_episode_steps = max_episode_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated: Optional[int] = None
        self._elapsed_steps: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict[str, Any]] = None
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None or self.np_random is None:
            self.np_random = np_random(seed)
        low, high = -0.05, 0.05
        if options is not None:
            low, high = options.get("low", low), options.get("high", high)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        if not self.action_space.contains(action):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        if self.state is None:
            raise RuntimeError("Call reset before using step method.")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)

        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 0.0 if self._sutton_barto_reward else 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = -1.0 if self._sutton_barto_reward else 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = -1.0 if self._sutton_barto_reward else 0.0

        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= self.max_episode_steps
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                truncated, {})

    def close(self) -> None:
        pass


#: Env ids ``make`` knows, with the keyword defaults ``gymnasium.make``
#: registers them with.
_REGISTRY = {"CartPole-v1": (CartPoleEnv, {"max_episode_steps": 500}),
             "Pendulum-v1": (PendulumEnv, {"max_episode_steps": 200})}


def make(name: str, **config: Any):
    """The env registered as ``name`` (``"CartPole-v1"`` or
    ``"Pendulum-v1"``), built with ``config`` over its registered
    defaults."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown env {name!r}: the port registers {sorted(_REGISTRY)}; "
            "pass a callable env(env_config) for any other")
    cls, defaults = _REGISTRY[name]
    return cls(**{**defaults, **config})
