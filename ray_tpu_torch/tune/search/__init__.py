"""Searchers (ref: python/ray/tune/search/ — searcher.py Searcher,
basic_variant.py BasicVariantGenerator, concurrency_limiter ConcurrencyLimiter).

A Searcher hands out concrete configs; the controller feeds results back so
adaptive searchers can condition future suggestions.

The counterpart of ``ray_tpu/tune/search/__init__.py``.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search_space import Domain, expand_grid, resolve

FINISHED = "FINISHED"  # sentinel: searcher exhausted


class Searcher:
    """(ref: tune/search/searcher.py Searcher)"""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: Optional[str],
                              config: Dict[str, Any]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid cross-product × num_samples random draws
    (ref: tune/search/basic_variant.py:109 BasicVariantGenerator)."""

    def __init__(self, space: Optional[Dict[str, Any]] = None, num_samples: int = 1,
                 seed: Optional[int] = None, points_to_evaluate: Optional[List[Dict]] = None):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._rng = random.Random(seed)
        self._queue: List[Dict[str, Any]] = list(points_to_evaluate or [])
        self._grid = expand_grid(self._space)
        self._emitted = 0
        self._total = len(self._grid) * num_samples + len(self._queue)

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config:
            self._space = config
            self._grid = expand_grid(config)
            self._total = len(self._grid) * self._num_samples + len(self._queue)
        return True

    @property
    def total_samples(self) -> int:
        return self._total

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._queue:
            return resolve(self._queue.pop(0), self._rng)
        if self._emitted >= len(self._grid) * self._num_samples:
            return None
        variant = self._grid[self._emitted % len(self._grid)]
        self._emitted += 1
        return resolve(variant, self._rng)


class RandomSearch(BasicVariantGenerator):
    """Pure random sampling over the space (grid leaves sampled uniformly too)."""

    def __init__(self, space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        flat = {
            k: (v if not (isinstance(v, dict) and set(v) == {"grid_search"})
                else _grid_to_choice(v))
            for k, v in space.items()
        }
        super().__init__(flat, num_samples=num_samples, seed=seed)


def _grid_to_choice(v: Dict[str, Any]) -> Domain:
    from ray_tpu_torch.tune.search_space import Categorical

    return Categorical(v["grid_search"])


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (ref: tune/search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return "PENDING"  # backpressure marker understood by controller
        cfg = self.searcher.suggest(trial_id)
        if isinstance(cfg, dict):
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class HyperOptStyleSearcher(Searcher):
    """A dependency-free adaptive searcher: random exploration that narrows
    around the best-seen configs (TPE-flavored exploitation without hyperopt).
    Stands in for the reference's hyperopt/optuna integrations
    (ref: tune/search/hyperopt/, tune/search/optuna/) since neither package
    ships in this environment.
    """

    def __init__(self, space: Dict[str, Any], metric: str, mode: str = "max",
                 num_samples: int = 1, seed: Optional[int] = None,
                 explore_fraction: float = 0.5):
        super().__init__(metric, mode)
        self._space = space
        self._num_samples = num_samples
        self._rng = random.Random(seed)
        self._emitted = 0
        self._observations: List[tuple] = []  # (score, config)
        self._explore_fraction = explore_fraction
        self._grid = expand_grid(space)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._emitted >= self._num_samples:
            return None
        self._emitted += 1
        base = self._grid[self._rng.randrange(len(self._grid))]
        if len(self._observations) < 3 or self._rng.random() < self._explore_fraction:
            return resolve(base, self._rng)
        # Exploit: jitter around a top-quartile config.
        ranked = sorted(self._observations, key=lambda t: t[0],
                        reverse=(self.mode == "max"))
        top = ranked[: max(1, len(ranked) // 4)]
        _, anchor = top[self._rng.randrange(len(top))]
        out = {}
        for k, v in base.items():
            if isinstance(v, Domain) and k in anchor and isinstance(anchor[k], (int, float)):
                jittered = anchor[k] * self._rng.uniform(0.8, 1.25)
                out[k] = type(anchor[k])(jittered)
            elif isinstance(v, Domain):
                out[k] = v.sample(self._rng)
            else:
                out[k] = v
        return out

    def on_trial_complete(self, trial_id, result=None, error=False):
        if result and not error and self.metric in result:
            self._observations.append((float(result[self.metric]),
                                       {k: v for k, v in result.get("config", {}).items()}))
