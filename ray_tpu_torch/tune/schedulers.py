"""Trial schedulers (ref: python/ray/tune/schedulers/ — trial_scheduler.py
TrialScheduler, async_hyperband.py ASHAScheduler, hyperband.py,
median_stopping_rule.py, pbt.py PopulationBasedTraining).

The controller calls ``on_trial_result`` after every reported result and acts
on the returned decision.

The counterpart of ``ray_tpu/tune/schedulers.py``.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional


class TrialScheduler:
    """(ref: tune/schedulers/trial_scheduler.py:23)"""

    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    def set_search_properties(self, metric: Optional[str], mode: Optional[str]) -> bool:
        return True

    def on_trial_add(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass

    def choose_trial_to_run(self, pending: List) -> Optional[Any]:
        return pending[0] if pending else None


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order
    (ref: trial_scheduler.py FIFOScheduler)."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (ref: tune/schedulers/async_hyperband.py
    AsyncHyperBandScheduler — rung-based promotion with reduction_factor).

    A trial reaching a rung milestone is stopped unless its metric is in the
    top 1/reduction_factor of results recorded at that rung.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration", max_t: int = 100,
                 grace_period: int = 1, reduction_factor: float = 4,
                 brackets: int = 1):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self._brackets: List[Dict[int, List[float]]] = []
        for b in range(brackets):
            rungs: Dict[int, List[float]] = {}
            t = grace_period * (reduction_factor ** b)
            while t < max_t:
                rungs[int(t)] = []
                t *= reduction_factor
            self._brackets.append(rungs)
        self._trial_bracket: Dict[str, int] = {}
        self._recorded: set = set()  # (trial_id, milestone) pairs already rung-recorded
        self._rng = random.Random(0)

    def set_search_properties(self, metric, mode) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_add(self, trial) -> None:
        self._trial_bracket[trial.trial_id] = self._rng.randrange(len(self._brackets))

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        rungs = self._brackets[self._trial_bracket.get(trial.trial_id, 0)]
        # Record once per rung at the first result past the milestone (ref:
        # async_hyperband.py _Bracket.on_result), but keep comparing the
        # trial's current score against the rung cutoff on later results too —
        # an early arrival judged against an empty rung must still be cuttable
        # once peers fill the rung in.
        for milestone in sorted(rungs, reverse=True):
            if t < milestone:
                continue
            key = (trial.trial_id, milestone)
            if key not in self._recorded:
                self._recorded.add(key)
                rungs[milestone].append(float(score))
            if not self._top_k(float(score), rungs[milestone]):
                return self.STOP
            break
        return self.CONTINUE

    def _top_k(self, score: float, recorded: List[float]) -> bool:
        if len(recorded) < self.rf:
            return True  # not enough data to cut yet
        ranked = sorted(recorded, reverse=(self.mode == "max"))
        cutoff = ranked[max(0, int(math.ceil(len(ranked) / self.rf)) - 1)]
        return (score >= cutoff) if self.mode == "max" else (score <= cutoff)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of the
    running means of other trials at the same step
    (ref: tune/schedulers/median_stopping_rule.py:18)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration", grace_period: int = 1,
                 min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._means: Dict[str, List[float]] = {}

    def set_search_properties(self, metric, mode) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        score = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if score is None:
            return self.CONTINUE
        hist = self._means.setdefault(trial.trial_id, [])
        hist.append(float(score))
        if t < self.grace_period or len(self._means) < self.min_samples:
            return self.CONTINUE
        my_mean = sum(hist) / len(hist)
        others = [sum(h) / len(h) for tid, h in self._means.items()
                  if tid != trial.trial_id and h]
        if len(others) < self.min_samples - 1:
            return self.CONTINUE
        others.sort()
        median = others[len(others) // 2]
        worse = my_mean < median if self.mode == "max" else my_mean > median
        return self.STOP if worse else self.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (ref: tune/schedulers/pbt.py:247 PopulationBasedTraining).

    Every ``perturbation_interval`` steps, a bottom-quantile trial exploits a
    top-quantile trial — clone its checkpoint + config — and explores by
    perturbing mutable hyperparameters.  The controller implements the clone
    by restarting the trial actor from the donor's checkpoint; the decision
    payload rides on ``trial.pbt_exploit``.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: Optional[int] = None,
                 perturbation_factors: tuple = (1.2, 0.8)):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.factors = perturbation_factors
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        self._trials: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_add(self, trial) -> None:
        self._trials[trial.trial_id] = trial

    def on_trial_complete(self, trial, result) -> None:
        self._trials.pop(trial.trial_id, None)
        self._scores.pop(trial.trial_id, None)

    def on_trial_error(self, trial) -> None:
        self.on_trial_complete(trial, None)

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        score = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if score is None:
            return self.CONTINUE
        self._scores[trial.trial_id] = float(score)
        if t - self._last_perturb.get(trial.trial_id, 0) < self.interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1],
                        reverse=(self.mode == "max"))
        n = len(ranked)
        if n < 2:
            return self.CONTINUE
        k = max(1, int(n * self.quantile))
        top = [tid for tid, _ in ranked[:k]]
        bottom = {tid for tid, _ in ranked[-k:]}
        if trial.trial_id in bottom and trial.trial_id not in top:
            donor_id = top[self._rng.randrange(len(top))]
            donor = self._trials.get(donor_id)
            if donor is not None and donor_id != trial.trial_id:
                trial.pbt_exploit = {
                    "donor": donor,
                    "new_config": self._explore(dict(donor.config)),
                }
                return self.PAUSE  # controller turns PAUSE+pbt_exploit into clone
        return self.CONTINUE

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search_space import Domain

        for key, spec in self.mutations.items():
            if key not in config:
                continue
            if isinstance(spec, list):
                config[key] = self._rng.choice(spec)
            elif isinstance(spec, Domain):
                if self._rng.random() < 0.25:
                    config[key] = spec.sample(self._rng)
                elif isinstance(config[key], (int, float)):
                    factor = self._rng.choice(self.factors)
                    config[key] = type(config[key])(config[key] * factor)
            elif callable(spec):
                config[key] = spec()
        return config


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (ref: tune/schedulers/pb2.py PB2 — PBT where
    explore() picks new hyperparameters with a GP-bandit (UCB) fit on
    observed (hyperparams -> reward improvement) data instead of random
    perturbation; Parker-Holder et al. 2020).

    Requires numeric search bounds: ``hyperparam_mutations`` values must be
    ``[low, high]`` lists or tune domains with numeric bounds.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=hyperparam_bounds,
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds: Dict[str, tuple] = {}
        for key, spec in (hyperparam_bounds or {}).items():
            if isinstance(spec, (list, tuple)) and len(spec) == 2:
                self.bounds[key] = (float(spec[0]), float(spec[1]))
            else:
                from ray_tpu_torch.tune.search_space import Domain

                if isinstance(spec, Domain) and hasattr(spec, "lower"):
                    self.bounds[key] = (float(spec.lower), float(spec.upper))
                else:
                    raise ValueError(
                        f"PB2 needs numeric [low, high] bounds for {key!r}")
        #: GP training data: rows of (normalized hyperparams, reward delta)
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._prev_score: Dict[str, float] = {}

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        score = result.get(self.metric)
        if score is not None:
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None:
                self._X.append(self._normalize(trial.config))
                delta = float(score) - prev
                self._y.append(delta if self.mode == "max" else -delta)
                if len(self._y) > 512:  # bound GP cost
                    self._X.pop(0)
                    self._y.pop(0)
            self._prev_score[trial.trial_id] = float(score)
        return super().on_trial_result(trial, result)

    def _normalize(self, config: Dict[str, Any]) -> List[float]:
        row = []
        for key, (lo, hi) in sorted(self.bounds.items()):
            v = float(config.get(key, lo))
            row.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return row

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """GP-UCB over candidate configs (the PB2 selection step)."""
        import numpy as np

        keys = sorted(self.bounds)
        if len(self._y) < 4:
            # Cold start: uniform sample inside bounds.
            for k in keys:
                lo, hi = self.bounds[k]
                config[k] = type(config.get(k, lo))(self._rng.uniform(lo, hi))
            return config
        X = np.asarray(self._X)
        y = np.asarray(self._y)
        y = (y - y.mean()) / (y.std() + 1e-8)

        def kernel(A, B, ls=0.2):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))

        K = kernel(X, X) + 1e-4 * np.eye(len(X))
        Kinv_y = np.linalg.solve(K, y)
        # Candidate pool: random points in the unit box.
        cands = np.asarray([[self._rng.random() for _ in keys]
                            for _ in range(64)])
        Ks = kernel(cands, X)
        mu = Ks @ Kinv_y
        Kinv_Ks = np.linalg.solve(K, Ks.T)
        var = np.clip(1.0 - np.einsum("ij,ji->i", Ks, Kinv_Ks), 1e-6, None)
        ucb = mu + 1.0 * np.sqrt(var)
        best = cands[int(np.argmax(ucb))]
        for k, u in zip(keys, best):
            lo, hi = self.bounds[k]
            v = lo + float(u) * (hi - lo)
            config[k] = type(config.get(k, v))(v) \
                if isinstance(config.get(k), (int, float)) else v
        return config
