"""Optuna searcher adapter (ref: python/ray/tune/search/optuna/
optuna_search.py:81 OptunaSearch).

Graceful-import shell (the pattern proven by air/integrations/wandb.py):
constructing the adapter without optuna installed raises a clear
ImportError naming the dependency; with optuna (or any module exposing the
same ask/tell study surface) present, suggestions come from
``study.ask()`` with our Domain objects converted to optuna distributions,
and completions feed back through ``study.tell``.

The counterpart of ``ray_tpu/tune/search/optuna.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search import Searcher
from ray_tpu_torch.tune.search_space import Categorical, Domain, Float, Integer


def _import_optuna():
    try:
        import optuna  # noqa: F401

        return optuna
    except ImportError as e:
        raise ImportError(
            "OptunaSearch requires the `optuna` package, which is not "
            "installed in this environment (pip install optuna)."
        ) from e


class OptunaSearch(Searcher):
    """Ask/tell bridge onto an optuna Study.

    space: {name: Domain | fixed value} — the same search-space dicts the
    native searchers take; Float/Integer/Categorical map to
    suggest_float/suggest_int/suggest_categorical.
    """

    def __init__(self, space: Dict[str, Any], metric: Optional[str] = None,
                 mode: str = "max", seed: Optional[int] = None,
                 study: Optional[Any] = None, _optuna_module=None):
        super().__init__(metric=metric, mode=mode)
        optuna = _optuna_module or _import_optuna()
        self._optuna = optuna
        self._space = space
        if study is not None:
            self._study = study
        else:
            sampler = optuna.samplers.TPESampler(seed=seed)
            self._study = optuna.create_study(
                direction="maximize" if mode == "max" else "minimize",
                sampler=sampler)
        self._trials: Dict[str, Any] = {}  # tune trial_id -> optuna trial

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        ot = self._study.ask()
        self._trials[trial_id] = ot
        config = {}
        for name, dom in self._space.items():
            if isinstance(dom, Float):
                config[name] = ot.suggest_float(name, dom.lower, dom.upper,
                                                log=dom.log)
            elif isinstance(dom, Integer):
                # Native Integer uppers are EXCLUSIVE (search_space.py);
                # optuna's high is inclusive.
                config[name] = ot.suggest_int(name, dom.lower,
                                              dom.upper - 1, log=dom.log)
            elif isinstance(dom, Categorical):
                config[name] = ot.suggest_categorical(name, list(dom.categories))
            elif isinstance(dom, Domain):
                raise TypeError(
                    f"OptunaSearch cannot convert domain {type(dom).__name__}"
                    f" for {name!r}")
            else:
                config[name] = dom  # fixed value
        return config

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        if error or not result or self.metric not in result:
            self._study.tell(ot, state=self._failed_state())
            return
        self._study.tell(ot, float(result[self.metric]))

    def _failed_state(self):
        try:
            return self._optuna.trial.TrialState.FAIL
        except AttributeError:
            return "FAIL"
