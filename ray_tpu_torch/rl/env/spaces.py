"""The spaces RL needs and gymnasium's seeding, without gymnasium.

The card's machine has no gymnasium. ``Discrete`` and ``Box`` sample as
``gymnasium.spaces`` 1.2 does from the same seed (``tests/
test_torch_rl_env.py`` holds them to it), and ``np_random`` makes the
generator ``gymnasium.utils.seeding.np_random`` makes.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

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
    """A box of floats or integers (ref: gymnasium/spaces/box.py Box),
    sampled as gymnasium samples one: uniform where both bounds are finite,
    shifted exponential where one is, normal where neither is; integer
    boxes floor a uniform over ``[low, high + 1)`` and clip to the dtype."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        super().__init__()
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "fiu":
            raise ValueError(f"Box supports float and integer dtypes, got {dtype}")
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(d) for d in shape)
        self.low = np.full(self.shape, low, dtype=self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype)
        self.bounded_below = -np.inf < self.low
        self.bounded_above = np.inf > self.high

    def sample(self) -> np.ndarray:
        high = (self.high if self.dtype.kind == "f"
                else self.high.astype("int64") + 1)
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
            size=upp_bounded[upp_bounded].shape) + high[upp_bounded])
        sample[bounded] = rng.uniform(low=self.low[bounded],
                                      high=high[bounded],
                                      size=bounded[bounded].shape)
        if self.dtype.kind != "f":
            info = np.iinfo(self.dtype)
            margin = 2 if self.dtype.kind == "i" else 0
            sample = np.floor(sample).clip(info.min + margin, info.max - margin)
        sample = sample.astype(self.dtype)
        if self.dtype == np.int64:
            sample = sample.clip(min=self.low, max=self.high)
        return sample

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and bool(np.all(x >= self.low))
                and bool(np.all(x <= self.high)))

    def __repr__(self) -> str:
        return f"Box({self.low}, {self.high}, {self.shape}, {self.dtype})"
