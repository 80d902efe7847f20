"""MLflow integration (ref: python/ray/air/integrations/mlflow.py
MLflowLoggerCallback:35 + setup_mlflow:150).

With ``mlflow`` importable, each trial becomes its OWN MLflow run driven
through ``MlflowClient`` by run id (never the global active-run stack —
concurrent trials would cross-log otherwise).  Without it (this image),
the fallback writes ``mlruns_offline/<trial_id>.jsonl`` with the same
params/metrics records, so the adapter is exercised end-to-end offline.

The counterpart of ``ray_tpu/air/integrations/mlflow.py``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.air.integrations._common import JsonlSink, numeric_metrics


def _mlflow_module():
    try:
        import mlflow  # noqa: F401

        return mlflow
    except ImportError:
        return None


class _ClientRun:
    """One trial's MLflow run, addressed by run_id via MlflowClient."""

    def __init__(self, client, run_id: str):
        self._client = client
        self._run_id = run_id

    def log_params(self, params: Dict[str, Any]) -> None:
        for k, v in (params or {}).items():
            self._client.log_param(self._run_id, k, v)

    def log_metrics(self, metrics: Dict[str, Any],
                    step: Optional[int] = None) -> None:
        ts = int(time.time() * 1000)
        for k, v in numeric_metrics(metrics).items():
            self._client.log_metric(self._run_id, k, v, timestamp=ts,
                                    step=step or 0)

    def end_run(self, status: str = "FINISHED") -> None:
        self._client.set_terminated(self._run_id, status=status)


class _OfflineMLflow:
    """mlflow-run-shaped shim over the JSONL sink."""

    def __init__(self, root: str, run_id: str, config):
        self._sink = JsonlSink(root, run_id,
                               {"type": "params", "params": config or {}})
        self.path = self._sink.path

    def log_params(self, params: Dict[str, Any]) -> None:
        self._sink.write({"type": "params", "params": params})

    def log_metrics(self, metrics: Dict[str, Any],
                    step: Optional[int] = None) -> None:
        self._sink.write({"type": "metrics", "step": step,
                          "metrics": numeric_metrics(metrics)})

    def end_run(self, status: str = "FINISHED") -> None:
        self._sink.close({"type": "end", "status": status})


def _client_run(mlflow, experiment_name: str,
                tracking_uri: Optional[str]) -> _ClientRun:
    client = mlflow.tracking.MlflowClient(tracking_uri=tracking_uri)
    exp = client.get_experiment_by_name(experiment_name)
    exp_id = exp.experiment_id if exp is not None \
        else client.create_experiment(experiment_name)
    run = client.create_run(exp_id)
    return _ClientRun(client, run.info.run_id)


def setup_mlflow(config: Optional[Dict[str, Any]] = None, *,
                 experiment_name: Optional[str] = None,
                 tracking_uri: Optional[str] = None, **kwargs):
    """Inside a train_loop/trainable: configure (or shim) mlflow
    (ref: integrations/mlflow.py setup_mlflow)."""
    mlflow = _mlflow_module()
    if mlflow is not None:
        run = _client_run(mlflow, experiment_name or "ray_tpu", tracking_uri)
        if config:
            run.log_params(config)
        return run
    import uuid

    run_id = experiment_name or f"run-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    return _OfflineMLflow(os.path.join(os.getcwd(), "mlruns_offline"),
                          run_id, config)


class MLflowLoggerCallback:
    """Tune callback: one MLflow run per trial
    (ref: integrations/mlflow.py:35)."""

    def __init__(self, experiment_name: str = "ray_tpu",
                 tracking_uri: Optional[str] = None,
                 save_dir: Optional[str] = None, **kwargs):
        self.experiment_name = experiment_name
        self.tracking_uri = tracking_uri
        self.save_dir = save_dir
        self.kwargs = kwargs
        self._runs: Dict[str, Any] = {}

    def _run_for(self, trial):
        run = self._runs.get(trial.trial_id)
        if run is None:
            mlflow = _mlflow_module()
            if mlflow is not None:
                run = _client_run(mlflow, self.experiment_name,
                                  self.tracking_uri)
                run.log_params(dict(trial.config or {}))
            else:
                base = self.save_dir or getattr(trial, "logdir", None) or "."
                run = _OfflineMLflow(os.path.join(base, "mlruns_offline"),
                                     trial.trial_id,
                                     dict(trial.config or {}))
            self._runs[trial.trial_id] = run
        return run

    def on_trial_start(self, trial=None, **kw) -> None:
        self._run_for(trial)

    def on_trial_result(self, trial=None, result=None, **kw) -> None:
        self._run_for(trial).log_metrics(
            result, step=int(result.get("training_iteration", 0)))

    def on_trial_complete(self, trial=None, **kw) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.end_run()

    def on_trial_error(self, trial=None, **kw) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.end_run(status="FAILED")

    def on_experiment_end(self, trials=None, **kw) -> None:
        for run in self._runs.values():
            run.end_run()
        self._runs.clear()
