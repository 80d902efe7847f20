"""Tuner — the experiment entry point (ref: python/ray/tune/tuner.py:44
Tuner, fit:344; tune/tune.py run for the legacy API).

The counterpart of ``ray_tpu/tune/tuner.py``.
"""

from __future__ import annotations

import inspect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    """(ref: tune/tune_config.py TuneConfig)"""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    time_budget_s: Optional[float] = None
    trial_resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})


class Tuner:
    """(ref: tuner.py:44)"""

    def __init__(
        self,
        trainable: Union[Callable, type],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_state: Optional[dict] = None
        self._restore_path: Optional[str] = None

    # ------------------------------------------------------------- restore
    @classmethod
    def restore(cls, path: str, trainable: Union[Callable, type],
                *, resume_errored: bool = True,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory
        (ref: tuner.py Tuner.restore / tune/execution/experiment_state.py).

        Finished trials are carried through as results; unfinished (and,
        with ``resume_errored``, errored) trials re-run with their recorded
        configs, restoring from their last checkpoint when one exists.
        """
        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        tuner = cls(trainable, tune_config=tune_config, run_config=run_config)
        tuner._restore_state = state
        tuner._restore_path = path
        tuner._resume_errored = resume_errored
        return tuner

    def _fit_restored(self) -> ResultGrid:
        from ray_tpu_torch.tune.trial import Trial

        tc = self.tune_config
        state = self._restore_state
        done_trials = []
        to_resume = []  # (config, checkpoint, trial_id)
        for t in state["trials"]:
            if t["status"] == Trial.TERMINATED:
                trial = Trial(t["config"], self._restore_path, {},
                              trial_id=t["trial_id"])
                trial.status = Trial.TERMINATED
                trial.last_result = t["last_result"]
                trial.checkpoint_path = t.get("checkpoint")
                done_trials.append(trial)
            elif t["status"] == Trial.ERROR and not self._resume_errored:
                continue
            else:
                to_resume.append((t["config"], t.get("checkpoint"),
                                  t["trial_id"]))
        resumed: list = []
        if to_resume:
            searcher = _ReplaySearcher([c for c, _, _ in to_resume])
            searcher.set_search_properties(tc.metric, tc.mode, {})
            controller = TuneController(
                trainable_cls=self._as_trainable_cls(self.trainable),
                searcher=searcher,
                scheduler=tc.scheduler or FIFOScheduler(),
                experiment_path=self._restore_path,
                experiment_name=os.path.basename(self._restore_path),
                metric=tc.metric, mode=tc.mode,
                stop=self.run_config.stop,
                max_concurrent_trials=tc.max_concurrent_trials,
                max_failures=self.run_config.failure_config.max_failures,
                trial_resources=dict(tc.trial_resources),
                time_budget_s=tc.time_budget_s,
                callbacks=self.run_config.callbacks,
                restore_checkpoints=_checkpoints_by_config(to_resume),
                # A resumed run must itself stay crash-resumable.
                snapshot_fn=lambda trials: self._save_experiment_state(
                    self._restore_path, done_trials + list(trials)),
            )
            resumed = controller.run()
        trials = done_trials + list(resumed)
        self._save_experiment_state(self._restore_path, trials)
        return ResultGrid(trials, tc.metric, tc.mode)

    def fit(self) -> ResultGrid:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if self._restore_state is not None:
            return self._fit_restored()
        tc = self.tune_config
        name = self.run_config.name or f"tune_{int(time.time())}"
        storage = self.run_config.storage_path or tempfile.mkdtemp(prefix="ray_tpu_tune_")
        experiment_path = os.path.join(storage, name)
        os.makedirs(experiment_path, exist_ok=True)

        trainable_cls = self._as_trainable_cls(self.trainable)
        # The trial actor is a lightweight controller; a Trainer inside a
        # trial reserves its own worker placement group (ref: Tune trial for a
        # Trainer requests the trainer's PG, workers request the rest).
        resources = dict(tc.trial_resources)
        searcher = tc.search_alg or BasicVariantGenerator(
            self.param_space, num_samples=tc.num_samples)
        searcher.set_search_properties(tc.metric, tc.mode, self.param_space)

        controller = TuneController(
            trainable_cls=trainable_cls,
            searcher=searcher,
            scheduler=tc.scheduler or FIFOScheduler(),
            experiment_path=experiment_path,
            experiment_name=name,
            metric=tc.metric,
            mode=tc.mode,
            stop=self.run_config.stop,
            max_concurrent_trials=tc.max_concurrent_trials,
            max_failures=self.run_config.failure_config.max_failures,
            trial_resources=resources,
            time_budget_s=tc.time_budget_s,
            callbacks=self.run_config.callbacks,
            # Periodic snapshots make the experiment restorable after a crash
            # (ref: experiment_state.py periodic checkpointing).
            snapshot_fn=lambda trials: self._save_experiment_state(
                experiment_path, trials),
        )
        trials = controller.run()
        self._save_experiment_state(experiment_path, trials)
        return ResultGrid(trials, tc.metric, tc.mode)

    @staticmethod
    def _as_trainable_cls(trainable) -> type:
        if inspect.isclass(trainable) and issubclass(trainable, Trainable):
            return trainable
        if callable(trainable):
            return wrap_function(trainable)
        raise TypeError(f"Not a trainable: {trainable!r}")

    def _save_experiment_state(self, experiment_path: str, trials) -> None:
        """Experiment snapshot for post-hoc analysis
        (ref: tune/execution/experiment_state.py checkpoints)."""
        state = {
            "timestamp": time.time(),
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "status": t.status,
                    "config": _json_safe(t.config),
                    "last_result": _json_safe(t.last_result or {}),
                    "logdir": t.logdir,
                    "checkpoint": t.checkpoint_path,
                    "error": repr(t.error) if t.error else None,
                }
                for t in trials
            ],
        }
        # Atomic write: the periodic snapshot exists to survive crashes, so
        # a crash mid-dump must never corrupt the previous valid snapshot.
        final = os.path.join(experiment_path, "experiment_state.json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, final)


def _checkpoints_by_config(to_resume) -> Dict[str, list]:
    """config-json -> [checkpoints, in original trial order].  A LIST per
    key because identical configs (num_samples>1 over a constant space) are
    distinct trials with distinct checkpoints; the controller pops in trial
    creation order so each resumed trial gets its own state back."""
    out: Dict[str, list] = {}
    for c, ckpt, _ in to_resume:
        if ckpt:
            out.setdefault(json.dumps(c, sort_keys=True, default=str),
                           []).append(ckpt)
    return out


class _ReplaySearcher(Searcher):
    """Feeds a fixed list of configs (experiment restore)."""

    def __init__(self, configs):
        self._configs = list(configs)
        self._i = 0

    def set_search_properties(self, metric, mode, param_space) -> bool:
        return True

    def suggest(self, trial_id: str):
        if self._i >= len(self._configs):
            from ray_tpu_torch.tune.search import FINISHED

            return FINISHED
        cfg = self._configs[self._i]
        self._i += 1
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        pass


def run(trainable, *, config: Optional[Dict[str, Any]] = None,
        metric: Optional[str] = None, mode: str = "max", num_samples: int = 1,
        stop: Optional[Dict[str, Any]] = None, search_alg=None, scheduler=None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_concurrent_trials: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        storage_path: Optional[str] = None, name: Optional[str] = None,
        max_failures: int = 0, verbose: int = 0,
        callbacks: Optional[list] = None) -> ResultGrid:
    """Legacy entry point (ref: tune/tune.py run)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    name = name or f"tune_{int(time.time())}"
    storage = storage_path or tempfile.mkdtemp(prefix="ray_tpu_tune_")
    experiment_path = os.path.join(storage, name)
    os.makedirs(experiment_path, exist_ok=True)
    trainable_cls = Tuner._as_trainable_cls(trainable)
    searcher = search_alg or BasicVariantGenerator(config or {}, num_samples=num_samples)
    searcher.set_search_properties(metric, mode, config or {})
    controller = TuneController(
        trainable_cls=trainable_cls, searcher=searcher,
        scheduler=scheduler or FIFOScheduler(),
        experiment_path=experiment_path, experiment_name=name,
        metric=metric, mode=mode, stop=stop,
        max_concurrent_trials=max_concurrent_trials, max_failures=max_failures,
        callbacks=callbacks,
        trial_resources=resources_per_trial or {"CPU": 1.0},
        time_budget_s=time_budget_s)
    trials = controller.run()
    return ResultGrid(trials, metric, mode)


def _json_safe(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in (d or {}).items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out
