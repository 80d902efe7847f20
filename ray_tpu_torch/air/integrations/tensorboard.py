"""TensorBoard logging (ref: python/ray/tune/logger/tensorboardx.py
TBXLoggerCallback — tensorboardX SummaryWriter per trial; JSONL fallback
when tensorboardX is absent, honoring the integrations contract that an
uninstalled backend never kills the experiment or drops metrics).

The counterpart of ``ray_tpu/air/integrations/tensorboard.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ray_tpu_torch.air.integrations._common import JsonlSink, numeric_metrics


class _JsonlScalarWriter:
    """SummaryWriter-shaped shim (add_scalar/close) over the JSONL sink."""

    def __init__(self, logdir: str, run_id: str):
        self._sink = JsonlSink(logdir, run_id, {"type": "tbx_fallback"})
        self.path = self._sink.path

    def add_scalar(self, key: str, value: float, global_step: int = 0) -> None:
        self._sink.write({"type": "scalar", "tag": key, "value": value,
                          "step": global_step})

    def close(self) -> None:
        self._sink.close()


class TBXLoggerCallback:
    """One tensorboardX event file per trial under the trial's logdir."""

    def __init__(self, logdir: Optional[str] = None):
        self._logdir = logdir
        self._writers: Dict[str, object] = {}

    def _writer_for(self, trial):
        w = self._writers.get(trial.trial_id)
        if w is None:
            base = self._logdir or getattr(trial, "logdir", None) \
                or getattr(trial, "local_path", None) or "."
            path = os.path.join(base, trial.trial_id) if self._logdir \
                else base
            try:
                from tensorboardX import SummaryWriter

                os.makedirs(path, exist_ok=True)
                w = SummaryWriter(logdir=path, flush_secs=5)
            except ImportError:
                w = _JsonlScalarWriter(path, trial.trial_id)
            self._writers[trial.trial_id] = w
        return w

    def on_trial_result(self, trial=None, result=None, **kw) -> None:
        w = self._writer_for(trial)
        step = int(result.get("training_iteration", 0))
        for key, value in numeric_metrics(result).items():
            w.add_scalar(key, value, global_step=step)

    def on_trial_complete(self, trial=None, **kw) -> None:
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()

    def on_trial_error(self, trial=None, **kw) -> None:
        self.on_trial_complete(trial=trial)

    def on_experiment_end(self, trials=None, **kw) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()
