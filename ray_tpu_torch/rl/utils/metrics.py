"""MetricsLogger — windowed metric aggregation.

(ref: rllib/utils/metrics/metrics_logger.py MetricsLogger — log_value/
log_dict with EMA or window reduction, nested key paths, reduce().) A
copy of ``ray_tpu/rl/utils/metrics.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np


class _Stat:
    def __init__(self, window: Optional[int] = None, reduce: str = "mean"):
        self.window = window
        self.reduce_method = reduce
        self.values: deque = deque(maxlen=window)

    def push(self, value) -> None:
        self.values.append(value)

    def peek(self):
        if not self.values:
            return None
        vals = list(self.values)
        if self.reduce_method == "mean":
            return float(np.mean(vals))
        if self.reduce_method == "sum":
            return float(np.sum(vals))
        if self.reduce_method == "max":
            return float(np.max(vals))
        if self.reduce_method == "min":
            return float(np.min(vals))
        return vals[-1]


class MetricsLogger:
    def __init__(self) -> None:
        self._stats: Dict[str, Dict[str, _Stat]] = {}

    def log_value(self, name: str, value, *, key: str = "", window: Optional[int] = None,
                  reduce: str = "mean") -> None:
        group = self._stats.setdefault(key, {})
        stat = group.get(name)
        if stat is None:
            stat = group[name] = _Stat(window=window, reduce=reduce)
        stat.push(value)

    def log_dict(self, metrics: Dict[str, Any], *, key: str = "",
                 window: Optional[int] = None, reduce: str = "mean") -> None:
        for name, value in metrics.items():
            if isinstance(value, (int, float, np.number)):
                self.log_value(name, value, key=key, window=window, reduce=reduce)

    def reduce(self, key: str = "") -> Dict[str, Any]:
        group = self._stats.get(key, {})
        return {name: stat.peek() for name, stat in group.items()
                if stat.peek() is not None}
