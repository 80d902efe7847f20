"""Replay buffers (ref: rllib/utils/replay_buffers/ — ReplayBuffer,
PrioritizedEpisodeReplayBuffer; stored as flat transition columns here since
the learner consumes column batches). A numpy copy of
``ray_tpu/rl/utils/replay_buffers.py``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rl.core.rl_module import Columns


class ReplayBuffer:
    """Uniform FIFO transition buffer."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._store: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(batch[Columns.OBS])
        if not self._store:
            for k, v in batch.items():
                self._store[k] = np.zeros((self.capacity, *v.shape[1:]), v.dtype)
        for i in range(n):
            for k, v in batch.items():
                self._store[k][self._next] = v[i]
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._store.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (ref: rllib/utils/replay_buffers/
    prioritized_episode_buffer.py; Schaul et al. 2015)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros((capacity,), np.float64)
        self._max_priority = 1.0
        self._last_idx: Optional[np.ndarray] = None

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(batch[Columns.OBS])
        start = self._next
        super().add(batch)
        for i in range(n):
            self._priorities[(start + i) % self.capacity] = self._max_priority

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        prios = self._priorities[:self._size] ** self.alpha
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, batch_size, p=probs)
        self._last_idx = idx
        weights = (self._size * probs[idx]) ** (-self.beta)
        out = {k: v[idx] for k, v in self._store.items()}
        out[Columns.WEIGHTS] = (weights / weights.max()).astype(np.float32)
        return out

    def update_priorities(self, td_errors: np.ndarray) -> None:
        assert self._last_idx is not None
        prios = np.abs(td_errors) + 1e-6
        self._priorities[self._last_idx] = prios
        self._max_priority = max(self._max_priority, float(prios.max()))
