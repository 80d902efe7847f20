"""The Tune control loop.

(ref: python/ray/tune/execution/tune_controller.py:68 TuneController — an
event-driven loop that creates trial actors, collects their results, asks the
scheduler for a decision per result, and the searcher for new configs.)

Each trial runs as a ``_TrainableActor`` — an actor holding the user's
Trainable; one ``train.remote()`` per iteration (ref: Trainable.train per-step
contract).  PBT exploits restart the victim actor from the donor's checkpoint
with a mutated config.

The counterpart of ``ray_tpu/tune/tune_controller.py``.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError, TaskError
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import FINISHED, Searcher
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.trainable import DONE, TRAINING_ITERATION, Trainable


@ray_tpu_torch.remote
class _TrainableActor:
    """Hosts one Trainable instance (ref: Tune's trial actor — the Trainable
    itself is the actor in the reference; here it is wrapped so any class can
    ride on the generic actor runtime)."""

    def __init__(self, trainable_cls: type, config: Dict[str, Any],
                 trial_dir: str, trial_id: str, trial_name: str,
                 restore_from: Optional[str] = None):
        self._trainable: Trainable = trainable_cls(
            config=config, trial_dir=trial_dir, trial_id=trial_id,
            trial_name=trial_name)
        if restore_from:
            self._trainable.restore(restore_from)

    def train(self) -> Dict[str, Any]:
        return self._trainable.train()

    def save(self) -> str:
        return self._trainable.save()

    def restore(self, path: str) -> None:
        self._trainable.restore(path)

    def stop(self) -> None:
        self._trainable.stop()


class TuneController:
    """(ref: tune_controller.py:68; step loop :666)"""

    def __init__(
        self,
        trainable_cls: type,
        searcher: Searcher,
        scheduler: Optional[TrialScheduler] = None,
        experiment_path: str = "",
        experiment_name: str = "tune",
        metric: Optional[str] = None,
        mode: str = "max",
        stop: Optional[Dict[str, Any]] = None,
        max_concurrent_trials: Optional[int] = None,
        max_failures: int = 0,
        trial_resources: Optional[Dict[str, float]] = None,
        checkpoint_frequency: int = 0,
        checkpoint_at_end: bool = False,
        callbacks: Optional[List] = None,
        time_budget_s: Optional[float] = None,
        snapshot_fn: Optional[Callable[[List["Trial"]], None]] = None,
        snapshot_period_s: float = 10.0,
        restore_checkpoints: Optional[Dict[str, List[str]]] = None,
    ):
        self.trainable_cls = trainable_cls
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.metric = metric
        self.mode = mode
        self.stop_criteria = stop or {}
        self.max_failures = max_failures
        self.trial_resources = trial_resources or {"CPU": 1.0}
        self.experiment_path = experiment_path
        self.experiment_name = experiment_name
        self.checkpoint_frequency = checkpoint_frequency
        self.checkpoint_at_end = checkpoint_at_end
        self.callbacks = callbacks or []
        self.time_budget_s = time_budget_s
        #: Periodic experiment-state writer (ref: experiment_state.py) —
        #: makes a crash-interrupted run restorable via Tuner.restore.
        self.snapshot_fn = snapshot_fn
        self.snapshot_period_s = snapshot_period_s
        self._last_snapshot = 0.0
        #: config-json -> checkpoint path for restored trials.
        self.restore_checkpoints = restore_checkpoints or {}

        self.trials: List[Trial] = []
        self._searcher_done = False
        self._max_concurrent = max_concurrent_trials or self._fit_concurrency()
        self.scheduler.set_search_properties(metric, mode)

    def _fit_concurrency(self) -> int:
        """How many trials the cluster can host at once."""
        total = ray_tpu_torch.cluster_resources()
        fits = []
        for key, need in self.trial_resources.items():
            if need > 0:
                fits.append(int(total.get(key, 0) / need))
        return max(1, min(fits) if fits else 4)

    # ------------------------------------------------------------- main loop
    def run(self) -> List[Trial]:
        deadline = (time.monotonic() + self.time_budget_s) if self.time_budget_s else None
        while True:
            self._maybe_create_trials()
            self._maybe_start_trials()
            live = [t for t in self.trials if t.status == Trial.RUNNING]
            if not live:
                if not any(t.status in (Trial.PENDING, Trial.PAUSED)
                           for t in self.trials):
                    break
                time.sleep(0.01)
                continue
            self._process_events(live)
            if (self.snapshot_fn is not None
                    and time.monotonic() - self._last_snapshot
                    > self.snapshot_period_s):
                self._last_snapshot = time.monotonic()
                try:
                    self.snapshot_fn(self.trials)
                except Exception:
                    pass  # snapshots must never kill the experiment
            if deadline and time.monotonic() > deadline:
                for t in live:
                    self._stop_trial(t, Trial.TERMINATED)
                break
        for cb in self.callbacks:
            if hasattr(cb, "on_experiment_end"):
                cb.on_experiment_end(trials=self.trials)
        return self.trials

    # --------------------------------------------------------- trial creation
    def _maybe_create_trials(self) -> None:
        while not self._searcher_done:
            active = sum(1 for t in self.trials
                         if t.status in (Trial.PENDING, Trial.RUNNING, Trial.PAUSED))
            if active >= self._max_concurrent * 2:
                return
            # The trial id is fixed BEFORE suggest() so searchers that key
            # per-trial state by the suggested id see the same id in every
            # later on_trial_result/on_trial_complete call.
            trial_id = uuid.uuid4().hex[:8]
            cfg = self.searcher.suggest(trial_id)
            if cfg is None or cfg == FINISHED:
                self._searcher_done = True
                return
            if cfg == "PENDING":  # ConcurrencyLimiter backpressure
                return
            trial = Trial(cfg, self.experiment_path, dict(self.trial_resources),
                          self.experiment_name, trial_id=trial_id)
            self.trials.append(trial)
            self.scheduler.on_trial_add(trial)
            for cb in self.callbacks:
                if hasattr(cb, "on_trial_start"):
                    cb.on_trial_start(trial=trial)

    def _maybe_start_trials(self) -> None:
        running = sum(1 for t in self.trials if t.status == Trial.RUNNING)
        pending = [t for t in self.trials if t.status == Trial.PENDING]
        budget = self._max_concurrent - running
        while budget > 0 and pending:
            trial = self.scheduler.choose_trial_to_run(pending)
            if trial is None:
                break
            pending.remove(trial)
            self._start_trial(trial)
            budget -= 1

    def _start_trial(self, trial: Trial, restore_from: Optional[str] = None) -> None:
        if restore_from is None and trial.checkpoint_path is None \
                and self.restore_checkpoints:
            # Experiment restore: resume this config from its recorded
            # checkpoint (keyed by config contents — trial ids are fresh;
            # duplicate configs pop their checkpoints in creation order).
            import json as _json

            key = _json.dumps(trial.config, sort_keys=True, default=str)
            ckpts = self.restore_checkpoints.get(key)
            if ckpts:
                # Persist on the trial so a retry after an early failure
                # restores from the SAME checkpoint instead of popping a
                # sibling's (or starting over).
                trial.checkpoint_path = ckpts.pop(0)
                restore_from = trial.checkpoint_path
        trial.actor = _TrainableActor.options(
            resources=trial.resources).remote(
            self.trainable_cls, trial.config, trial.logdir, trial.trial_id,
            trial.trial_name, restore_from or trial.checkpoint_path)
        trial.inflight = trial.actor.train.remote()
        trial.status = Trial.RUNNING

    # ------------------------------------------------------------ event pump
    def _process_events(self, live: List[Trial]) -> None:
        refs = [t.inflight for t in live]
        # Drain every ready trial this pump — taking only the first would let
        # list order starve the rest (ASHA needs rung records from all peers).
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0.2)
        if not ready:
            return
        by_ref = {t.inflight: t for t in live}
        for ref in ready:
            trial = by_ref[ref]
            try:
                result = ray_tpu_torch.get(ref)
            except (TaskError, RayTpuError) as e:
                self._on_trial_error(trial, e)
                continue
            self._on_trial_result(trial, result)

    def _on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> None:
        trial.results.append(result)
        trial.last_result = result
        self.searcher.on_trial_result(trial.trial_id, result)
        for cb in self.callbacks:
            if hasattr(cb, "on_trial_result"):
                cb.on_trial_result(trial=trial, result=result)

        if result.get(DONE) or self._hit_stop_criteria(result):
            self._complete_trial(trial, result)
            return

        if (self.checkpoint_frequency
                and result.get(TRAINING_ITERATION, 0) % self.checkpoint_frequency == 0):
            try:
                trial.checkpoint_path = ray_tpu_torch.get(trial.actor.save.remote())
            except (TaskError, RayTpuError):
                pass

        decision = self.scheduler.on_trial_result(trial, result)
        if decision == TrialScheduler.STOP:
            self._complete_trial(trial, result)
        elif decision == TrialScheduler.PAUSE and trial.pbt_exploit is not None:
            self._pbt_clone(trial)
        elif decision == TrialScheduler.PAUSE:
            self._pause_trial(trial)
        else:
            trial.inflight = trial.actor.train.remote()

    def _hit_stop_criteria(self, result: Dict[str, Any]) -> bool:
        for key, bound in self.stop_criteria.items():
            if callable(bound):
                if bound(result.get("trial_id", ""), result):
                    return True
            elif key in result and result[key] >= bound:
                return True
        return False

    def _on_trial_error(self, trial: Trial, error: BaseException) -> None:
        trial.num_failures += 1
        self._teardown_actor(trial)
        # max_failures < 0 means retry forever (FailureConfig contract;
        # matches train/trainer.py's handling of the same config).
        if self.max_failures < 0 or trial.num_failures <= self.max_failures:
            # retry from last checkpoint (ref: trial FSM retry w/ restore)
            trial.status = Trial.PENDING
            return
        trial.status = Trial.ERROR
        trial.error = error
        self.scheduler.on_trial_error(trial)
        self.searcher.on_trial_complete(trial.trial_id, error=True)
        for cb in self.callbacks:
            if hasattr(cb, "on_trial_error"):
                cb.on_trial_error(trial=trial, error=error)

    def _complete_trial(self, trial: Trial, result: Dict[str, Any]) -> None:
        if self.checkpoint_at_end:
            try:
                trial.checkpoint_path = ray_tpu_torch.get(trial.actor.save.remote())
            except (TaskError, RayTpuError):
                pass
        self._stop_trial(trial, Trial.TERMINATED)
        self.scheduler.on_trial_complete(trial, result)
        self.searcher.on_trial_complete(trial.trial_id, result)
        for cb in self.callbacks:
            if hasattr(cb, "on_trial_complete"):
                cb.on_trial_complete(trial=trial, result=result)

    def _pause_trial(self, trial: Trial) -> None:
        try:
            trial.checkpoint_path = ray_tpu_torch.get(trial.actor.save.remote())
        except (TaskError, RayTpuError):
            pass
        self._teardown_actor(trial)
        trial.status = Trial.PAUSED
        # PAUSED trials become PENDING again immediately — the scheduler
        # decides when to pick them back up via choose_trial_to_run.
        trial.status = Trial.PENDING

    def _pbt_clone(self, trial: Trial) -> None:
        """Exploit+explore: restart this trial from the donor's checkpoint
        with the mutated config (ref: pbt.py _exploit)."""
        payload, trial.pbt_exploit = trial.pbt_exploit, None
        donor: Trial = payload["donor"]
        try:
            donor_ckpt = ray_tpu_torch.get(donor.actor.save.remote()) \
                if donor.actor is not None else donor.checkpoint_path
        except (TaskError, RayTpuError):
            donor_ckpt = donor.checkpoint_path
        self._teardown_actor(trial)
        trial.config = payload["new_config"]
        trial.checkpoint_path = donor_ckpt
        self._start_trial(trial, restore_from=donor_ckpt)

    def _stop_trial(self, trial: Trial, status: str) -> None:
        self._teardown_actor(trial)
        trial.status = status

    def _teardown_actor(self, trial: Trial) -> None:
        if trial.actor is not None:
            try:
                ray_tpu_torch.get(trial.actor.stop.remote(), timeout=2.0)
            except (TaskError, RayTpuError, TimeoutError, Exception):
                pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
            trial.inflight = None
