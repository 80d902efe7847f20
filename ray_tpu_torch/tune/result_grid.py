"""ResultGrid: the return value of Tuner.fit()
(ref: python/ray/tune/result_grid.py ResultGrid — per-trial Result access,
get_best_result).

The counterpart of ``ray_tpu/tune/result_grid.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.trainer import Result
from ray_tpu_torch.tune.trial import Trial


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str] = None,
                 mode: str = "max"):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._trials)

    def __getitem__(self, i: int) -> Result:
        return self._to_result(self._trials[i])

    def __iter__(self):
        return (self._to_result(t) for t in self._trials)

    @property
    def errors(self) -> List[BaseException]:
        return [t.error for t in self._trials if t.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._trials if t.status == Trial.TERMINATED)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("Pass metric= or set TuneConfig(metric=...)")
        # Rank by each trial's LAST report (ref: ResultGrid scope="last"
        # default) so the ranking agrees with the Result.metrics returned.
        scored = [((t.last_result or {}).get(metric), t) for t in self._trials]
        scored = [(s, t) for s, t in scored if s is not None]
        if not scored:
            raise RuntimeError("No trial reported the metric "
                               f"{metric!r}; errors: {self.errors}")
        best = max(scored, key=lambda st: st[0]) if mode == "max" \
            else min(scored, key=lambda st: st[0])
        return self._to_result(best[1])

    def get_dataframe(self):
        """Last-result table; requires pandas (present via jax deps)."""
        import pandas as pd

        rows = []
        for t in self._trials:
            row = dict(t.last_result or {})
            row.pop("config", None)
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)

    def _to_result(self, trial: Trial) -> Result:
        ckpt = Checkpoint(trial.checkpoint_path) if trial.checkpoint_path else None
        return Result(metrics=trial.last_result, checkpoint=ckpt,
                      path=trial.logdir, error=trial.error,
                      metrics_history=list(trial.results))
