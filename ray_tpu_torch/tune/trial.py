"""Trial: one hyperparameter configuration's lifecycle
(ref: python/ray/tune/experiment/trial.py:248 Trial — status FSM, config,
checkpoint bookkeeping, resources).

The counterpart of ``ray_tpu/tune/trial.py``.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(self, config: Dict[str, Any], experiment_path: str,
                 trial_resources: Optional[Dict[str, float]] = None,
                 experiment_name: str = "", trial_id: Optional[str] = None):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.config = config
        self.status = Trial.PENDING
        self.resources = trial_resources or {"CPU": 1.0}
        self.experiment_name = experiment_name
        self.trial_name = f"{experiment_name}_{self.trial_id}"
        self.logdir = os.path.join(experiment_path, self.trial_name)
        os.makedirs(self.logdir, exist_ok=True)

        self.results: List[Dict[str, Any]] = []
        self.last_result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.num_failures = 0
        self.checkpoint_path: Optional[str] = None  # latest saved checkpoint dir
        # PBT exploit payload set by the scheduler (donor trial + new config).
        self.pbt_exploit: Optional[Dict[str, Any]] = None

        # runtime handles (controller-owned)
        self.actor = None
        self.inflight = None  # ObjectRef of the outstanding train() call

    def best_metric(self, metric: str, mode: str) -> Optional[float]:
        vals = [r[metric] for r in self.results if metric in r]
        if not vals:
            return None
        return max(vals) if mode == "max" else min(vals)

    def __repr__(self) -> str:
        return f"Trial({self.trial_id}, {self.status}, config={self.config})"
