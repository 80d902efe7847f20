"""BOHB adapter: TuneBOHB searcher + HyperBandForBOHB scheduler (ref:
python/ray/tune/search/bohb/bohb_search.py TuneBOHB +
tune/schedulers/hb_bohb.py HyperBandForBOHB).

The searcher is a graceful-import shell over ConfigSpace (the library BOHB
defines its spaces in): without ConfigSpace it raises a clear ImportError
at construction; with it (or any module exposing the same
ConfigurationSpace surface) our Domains convert to CS hyperparameters and
suggestions come from ``sample_configuration``, model-weighted by the
top-performing completions so far (the BOHB KDE role, reduced to a
sample-and-rank step that needs no hpbandster).

HyperBandForBOHB is real and dependency-free: successive-halving brackets
over the report budget, pausing the bottom fraction at each rung — the
scheduler half of BOHB, usable with ANY searcher.

The counterpart of ``ray_tpu/tune/search/bohb.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import Searcher
from ray_tpu_torch.tune.search_space import Categorical, Domain, Float, Integer


def _import_configspace():
    try:
        import ConfigSpace  # noqa: F401

        return ConfigSpace
    except ImportError as e:
        raise ImportError(
            "TuneBOHB requires the `ConfigSpace` package, which is not "
            "installed in this environment (pip install ConfigSpace)."
        ) from e


class TuneBOHB(Searcher):
    """ConfigSpace-backed model-lite BOHB searcher shell."""

    def __init__(self, space: Dict[str, Any], metric: Optional[str] = None,
                 mode: str = "max", seed: Optional[int] = None,
                 top_fraction: float = 0.3, _configspace_module=None):
        super().__init__(metric=metric, mode=mode)
        cs = _configspace_module or _import_configspace()
        self._cs_space = cs.ConfigurationSpace(seed=seed)
        self._fixed: Dict[str, Any] = {}
        for name, dom in space.items():
            if isinstance(dom, Float):
                hp = cs.UniformFloatHyperparameter(
                    name, lower=dom.lower, upper=dom.upper, log=dom.log)
            elif isinstance(dom, Integer):
                # Native Integer uppers are EXCLUSIVE; ConfigSpace's is
                # inclusive.
                hp = cs.UniformIntegerHyperparameter(
                    name, lower=dom.lower, upper=dom.upper - 1)
            elif isinstance(dom, Categorical):
                hp = cs.CategoricalHyperparameter(name, list(dom.categories))
            elif isinstance(dom, Domain):
                raise TypeError(
                    f"TuneBOHB cannot convert domain {type(dom).__name__} "
                    f"for {name!r}")
            else:
                self._fixed[name] = dom
                continue
            self._cs_space.add(hp) if hasattr(self._cs_space, "add") \
                else self._cs_space.add_hyperparameter(hp)
        self._top_fraction = top_fraction
        self._completed: List[tuple] = []  # (score, config)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        # BOHB-lite: draw a handful of candidates; past the warmup, pick
        # the one nearest (L0 over categoricals / normalized L1 elsewhere)
        # to a random member of the top fraction — the KDE "model" reduced
        # to sample-and-rank, which needs no hpbandster.
        candidates = [dict(self._cs_space.sample_configuration())
                      for _ in range(8)]
        pick = candidates[0]
        if len(self._completed) >= 4:
            sign = 1.0 if self.mode == "max" else -1.0
            ranked = sorted(self._completed, key=lambda t: -sign * t[0])
            top = ranked[:max(1, int(len(ranked) * self._top_fraction))]
            anchor = top[len(self._completed) % len(top)][1]
            pick = min(candidates, key=lambda c: self._distance(c, anchor))
        return {**self._fixed, **pick}

    @staticmethod
    def _distance(a: Dict[str, Any], b: Dict[str, Any]) -> float:
        d = 0.0
        for k, va in a.items():
            vb = b.get(k)
            if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
                scale = max(abs(va), abs(vb), 1e-9)
                d += abs(va - vb) / scale
            else:
                d += 0.0 if va == vb else 1.0
        return d

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        if error or not result or self.metric not in result:
            return
        cfg = {k: v for k, v in result.get("config", {}).items()}
        self._completed.append((float(result[self.metric]), cfg))


class HyperBandForBOHB(TrialScheduler):
    """Successive-halving brackets over the report budget (ref:
    tune/schedulers/hb_bohb.py) — pause-and-resume-free reduction: at each
    rung, trials below the top 1/reduction_factor quantile STOP."""

    def __init__(self, metric: str, mode: str = "max",
                 max_t: int = 100, reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        self.time_attr = time_attr
        # Integer division, not int(math.log(max_t, rf)): the float log of an
        # exact power (log(9, 3)) can land just under the integer and silently
        # drop the lowest rung.
        rungs = set()
        r = max_t
        while r > 1:
            rungs.add(r)
            r //= reduction_factor
        self._rungs = sorted(rungs or {max_t})
        self._rung_scores: Dict[int, List[float]] = {r: [] for r in self._rungs}
        #: (trial identity, rung) -> signed score recorded ONCE per rung;
        #: later reports re-evaluate against the (growing) rung population,
        #: so an early reporter that snuck past a not-yet-quorate rung is
        #: still cut on its next report once the cutoff exists.
        self._recorded: Dict[tuple, float] = {}
        #: id()-keyed trials pinned alive: a freed trial's id can be reused
        #: by a NEW trial, which would then inherit the dead one's rung
        #: records and dodge the cutoff.
        self._anon_trials: Dict[int, Any] = {}

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        score = result.get(self.metric)
        if score is None:
            return TrialScheduler.CONTINUE
        if t >= self.max_t:
            return TrialScheduler.STOP
        sign = 1.0 if self.mode == "max" else -1.0
        rung = max((r for r in self._rungs if r <= t), default=None)
        if rung is None:
            return TrialScheduler.CONTINUE
        tid = getattr(trial, "trial_id", None)
        if tid is None:
            tid = id(trial)
            self._anon_trials[tid] = trial
        key = (tid, rung)
        if key not in self._recorded:
            self._recorded[key] = sign * score
            self._rung_scores[rung].append(sign * score)
        scores = self._rung_scores[rung]
        if len(scores) >= self.rf:
            keep = max(1, len(scores) // self.rf)
            cutoff = sorted(scores, reverse=True)[keep - 1]
            if self._recorded[key] < cutoff:
                return TrialScheduler.STOP
        return TrialScheduler.CONTINUE
