"""CartPole-v1 and the two spaces RL needs, without gymnasium.

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


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """(ref: gymnasium/utils/seeding.py np_random)"""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class Space:
    """A space with a lazily seeded generator (ref: gymnasium/spaces/
    space.py Space.seed / np_random)."""

    shape: Tuple[int, ...] = ()

    def __init__(self) -> None:
        self._np_random: Optional[np.random.Generator] = None

    def seed(self, seed: Optional[int] = None) -> None:
        self._np_random = np_random(seed)

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self.seed()
        return self._np_random


class Discrete(Space):
    """{start, ..., start + n - 1} (ref: gymnasium/spaces/discrete.py)."""

    def __init__(self, n: int, start: int = 0):
        super().__init__()
        self.n = int(n)
        self.start = int(start)

    def sample(self) -> np.int64:
        return np.int64(self.start + self.np_random.integers(self.n,
                                                             dtype=np.int64))

    def contains(self, x: Any) -> bool:
        if isinstance(x, (int, np.integer)) or (
                isinstance(x, np.ndarray) and x.shape == ()
                and np.issubdtype(x.dtype, np.integer)):
            return self.start <= int(x) < self.start + self.n
        return False

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class Box(Space):
    """A float box (ref: gymnasium/spaces/box.py Box), sampled as gymnasium
    samples one: uniform where both bounds are finite, shifted exponential
    where one is, normal where neither is."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        super().__init__()
        self.dtype = np.dtype(dtype)
        if self.dtype.kind != "f":
            raise ValueError(f"Box supports float dtypes only, got {dtype}")
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(d) for d in shape)
        self.low = np.full(self.shape, low, dtype=self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype)
        self.bounded_below = -np.inf < self.low
        self.bounded_above = np.inf > self.high

    def sample(self) -> np.ndarray:
        sample = np.empty(self.shape)
        unbounded = ~self.bounded_below & ~self.bounded_above
        upp_bounded = ~self.bounded_below & self.bounded_above
        low_bounded = self.bounded_below & ~self.bounded_above
        bounded = self.bounded_below & self.bounded_above
        rng = self.np_random
        sample[unbounded] = rng.normal(size=unbounded[unbounded].shape)
        sample[low_bounded] = (rng.exponential(
            size=low_bounded[low_bounded].shape) + self.low[low_bounded])
        sample[upp_bounded] = (-rng.exponential(
            size=upp_bounded[upp_bounded].shape) + self.high[upp_bounded])
        sample[bounded] = rng.uniform(low=self.low[bounded],
                                      high=self.high[bounded],
                                      size=bounded[bounded].shape)
        return sample.astype(self.dtype)

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and bool(np.all(x >= self.low))
                and bool(np.all(x <= self.high)))

    def __repr__(self) -> str:
        return f"Box({self.low}, {self.high}, {self.shape}, {self.dtype})"


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
_REGISTRY = {"CartPole-v1": (CartPoleEnv, {"max_episode_steps": 500})}


def make(name: str, **config: Any):
    """The env registered as ``name`` (only ``"CartPole-v1"``), built with
    ``config`` over its registered defaults."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown env {name!r}: the port registers {sorted(_REGISTRY)}; "
            "pass a callable env(env_config) for any other")
    cls, defaults = _REGISTRY[name]
    return cls(**{**defaults, **config})
