"""Weights & Biases integration (ref: python/ray/air/integrations/wandb.py
WandbLoggerCallback:155 + setup_wandb:60).

When ``wandb`` is importable, each trial becomes a run (config = trial
config, metrics via ``wandb.log``).  This image has no wandb (and no
egress), so the fallback sink writes the SAME records as JSONL under the
trial's logdir (``wandb_offline/<trial_id>.jsonl`` — a ``config`` row,
then ``log`` rows with metrics nested) — nothing is silently dropped, and
the adapter shape is proven without the dependency.

The counterpart of ``ray_tpu/air/integrations/wandb.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ray_tpu_torch.air.integrations._common import JsonlSink, numeric_metrics


def _wandb_module():
    try:
        import wandb  # noqa: F401

        return wandb
    except ImportError:
        return None


class _OfflineRun:
    """wandb-run-shaped shim over the JSONL sink."""

    def __init__(self, root: str, run_id: str, config):
        self._sink = JsonlSink(root, run_id,
                               {"type": "config", "config": config or {}})
        self.path = self._sink.path

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        self._sink.write({"type": "log", "step": step,
                          "metrics": numeric_metrics(metrics)})

    def finish(self) -> None:
        self._sink.close({"type": "finish"})


def setup_wandb(config: Optional[Dict[str, Any]] = None, *,
                project: Optional[str] = None, trial_id: str = "",
                trial_name: str = "", **kwargs):
    """Inside a train_loop/trainable: start (or shim) a wandb run
    (ref: integrations/wandb.py setup_wandb).  Returns the live ``wandb``
    module or a file-backed shim exposing ``log``/``finish``."""
    wandb = _wandb_module()
    if wandb is not None:
        return wandb.init(project=project, name=trial_name or None,
                          id=trial_id or None, config=config, **kwargs)
    import uuid

    run_id = trial_id or f"run-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    return _OfflineRun(os.path.join(os.getcwd(), "wandb_offline"),
                       run_id, config)


class WandbLoggerCallback:
    """Tune callback: one wandb run per trial
    (ref: integrations/wandb.py:155)."""

    def __init__(self, project: str = "ray_tpu", group: Optional[str] = None,
                 dir: Optional[str] = None, **init_kwargs):  # noqa: A002
        self.project = project
        self.group = group
        self.dir = dir
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def _run_for(self, trial):
        run = self._runs.get(trial.trial_id)
        if run is None:
            wandb = _wandb_module()
            if wandb is not None:
                # reinit="create_new" returns an INDEPENDENT Run object per
                # trial (log/finish on the object, never the module) — the
                # concurrent-trials pattern; plain reinit=True would finish
                # the previous trial's run on every new start.  Older wandb
                # releases reject the string value: fall back rather than
                # kill the experiment from inside a logger.
                kw = dict(project=self.project, group=self.group,
                          id=trial.trial_id, name=str(trial),
                          config=dict(trial.config or {}), dir=self.dir,
                          **self.init_kwargs)
                try:
                    run = wandb.init(reinit="create_new", **kw)
                except (TypeError, ValueError) as e:
                    # Only the reinit rejection falls back: any OTHER config
                    # error must not trigger a second init (reinit=True
                    # finishes the previous concurrent trial's run).
                    if "reinit" not in str(e).lower():
                        raise
                    run = wandb.init(reinit=True, **kw)
            else:
                base = self.dir or getattr(trial, "logdir", None) or "."
                run = _OfflineRun(os.path.join(base, "wandb_offline"),
                                  trial.trial_id, dict(trial.config or {}))
            self._runs[trial.trial_id] = run
        return run

    def on_trial_start(self, trial=None, **kw) -> None:
        self._run_for(trial)

    def on_trial_result(self, trial=None, result=None, **kw) -> None:
        # The sink/backend filters once: wandb logs rich values natively,
        # the offline sink keeps numerics.
        self._run_for(trial).log(
            dict(result or {}), step=int(result.get("training_iteration", 0)))

    def on_trial_complete(self, trial=None, **kw) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish()

    def on_trial_error(self, trial=None, **kw) -> None:
        self.on_trial_complete(trial=trial)

    def on_experiment_end(self, trials=None, **kw) -> None:
        for run in self._runs.values():
            run.finish()
        self._runs.clear()
