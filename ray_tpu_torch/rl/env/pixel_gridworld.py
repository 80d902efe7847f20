"""PixelGridworld — a pixel-observation environment that needs no download.

The port of ``ray_tpu/rl/env/pixel_gridworld.py``: the stand-in for the
Atari/IMPALA pixel benchmarks (ref: rllib/tuned_examples/impala/) that
gates the CNN path. A plain class over the port's ``Box`` and ``Discrete``
(``gym.Env`` is not on the card's machine), with the reference's rendering,
rewards and numpy seeding, step for step.

The agent (red block) must reach the goal (green block) on an ``n x n``
grid; observations are (n*cell, n*cell, 3) uint8 images, actions the 4
moves. Reward: +1 at the goal (terminates), -0.01 per step; ``shaped`` adds
+-0.1 per step of progress toward or away from the goal (potential-based,
so the optimal policy is unchanged).
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rl.env.spaces import Box, Discrete


class PixelGridworld:
    metadata = {"render_modes": []}

    def __init__(self, n: int = 5, cell: int = 2, max_steps: int = 30,
                 shaped: bool = False, seed: int = 0):
        self.n = int(n)
        self.cell = int(cell)
        self.max_steps = int(max_steps)
        self.shaped = bool(shaped)
        side = self.n * self.cell
        self.observation_space = Box(low=0, high=255, shape=(side, side, 3),
                                     dtype=np.uint8)
        self.action_space = Discrete(4)
        self._rng = np.random.default_rng(seed)
        self._goal = (self.n - 1, self.n - 1)
        self._pos = (0, 0)
        self._t = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        while True:
            pos = (int(self._rng.integers(self.n)),
                   int(self._rng.integers(self.n)))
            if pos != self._goal:
                break
        self._pos = pos
        self._t = 0
        return self._render(), {}

    def _dist(self, pos) -> int:
        return abs(pos[0] - self._goal[0]) + abs(pos[1] - self._goal[1])

    def step(self, action: int):
        r, c = self._pos
        prev_dist = self._dist(self._pos)
        dr, dc = ((-1, 0), (1, 0), (0, -1), (0, 1))[int(action)]
        self._pos = (min(self.n - 1, max(0, r + dr)),
                     min(self.n - 1, max(0, c + dc)))
        self._t += 1
        terminated = self._pos == self._goal
        truncated = self._t >= self.max_steps and not terminated
        reward = 1.0 if terminated else -0.01
        if self.shaped:
            reward += 0.1 * (prev_dist - self._dist(self._pos))
        return self._render(), reward, terminated, truncated, {}

    def _render(self) -> np.ndarray:
        side = self.n * self.cell
        img = np.zeros((side, side, 3), np.uint8)

        def paint(rc, channel):
            r, c = rc
            img[r * self.cell:(r + 1) * self.cell,
                c * self.cell:(c + 1) * self.cell, channel] = 255

        paint(self._goal, 1)  # green goal
        paint(self._pos, 0)   # red agent (drawn over the goal if reached)
        return img

    def close(self):
        pass


def make_pixel_gridworld(config: dict) -> PixelGridworld:
    """Env factory for ``AlgorithmConfig.environment(make_pixel_gridworld)``."""
    return PixelGridworld(**(config or {}))
