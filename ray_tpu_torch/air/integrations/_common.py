"""Shared plumbing for the logger integrations: the numeric-metric filter
and the offline JSONL sink every backend falls back to when its tracking
library is absent.  Record shape: a ``type`` discriminator plus payload
keys; user metrics always nest under ``metrics`` so a metric named
``step`` or ``type`` can never clobber the record schema.

The counterpart of ``ray_tpu/air/integrations/_common.py``.
"""

from __future__ import annotations

import json
import numbers
import os
from typing import Any, Dict, Optional


def numeric_metrics(result: Optional[Dict[str, Any]]) -> Dict[str, float]:
    return {k: float(v) for k, v in (result or {}).items()
            if isinstance(v, numbers.Number) and not isinstance(v, bool)}


class JsonlSink:
    """Append-only JSONL run log under ``<root>/<run_id>.jsonl``."""

    def __init__(self, root: str, run_id: str, header: Dict[str, Any]):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, f"{run_id}.jsonl")
        self._f = open(self.path, "a")
        self.write(header)

    def write(self, row: Dict[str, Any]) -> None:
        self._f.write(json.dumps(row, default=str) + "\n")
        self._f.flush()

    def close(self, final: Optional[Dict[str, Any]] = None) -> None:
        if final is not None:
            self.write(final)
        self._f.close()
