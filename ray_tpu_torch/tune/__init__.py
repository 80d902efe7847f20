"""ray_tpu_torch.tune — hyperparameter tuning (ref: python/ray/tune/).

Surface: Tuner/TuneConfig/run, search-space constructors, searchers,
ASHA/PBT/median-stopping schedulers, Trainable class + function APIs, and a
``tune.report`` that shares the Train session plumbing (in the reference both
route through ray.train's session since 2.x).

The counterpart of ``ray_tpu/tune/__init__.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.train import checkpoint as _ckpt
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig
from ray_tpu_torch.train.session import get_session
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    HyperOptStyleSearcher,
    RandomSearch,
    Searcher,
)
from ray_tpu_torch.tune.search_space import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    qloguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import Trainable, with_parameters
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run

Checkpoint = _ckpt.Checkpoint

__all__ = [
    "Tuner", "TuneConfig", "run", "Trainable", "with_parameters", "report",
    "get_checkpoint", "Searcher", "BasicVariantGenerator", "RandomSearch",
    "ConcurrencyLimiter", "HyperOptStyleSearcher", "TrialScheduler",
    "FIFOScheduler", "ASHAScheduler", "MedianStoppingRule",
    "PB2", "PopulationBasedTraining", "ResultGrid", "Trial", "Checkpoint",
    "RunConfig", "FailureConfig", "CheckpointConfig",
    "uniform", "quniform", "loguniform", "qloguniform", "randn", "randint",
    "qrandint", "lograndint", "choice", "sample_from", "grid_search",
]


def report(metrics: Optional[Dict[str, Any]] = None,
           checkpoint: Optional[Checkpoint] = None, **kwargs: Any) -> None:
    """Report metrics (+ optional checkpoint) from a function trainable.

    Accepts both the modern ``tune.report({"loss": x})`` and the legacy
    kwargs form ``tune.report(loss=x)`` (ref: tune's report in
    train/_internal/session.py:672 and legacy tune/trainable/session.py).
    """
    merged = dict(metrics or {})
    merged.update(kwargs)
    session = get_session()
    if session is None:
        raise RuntimeError("tune.report() called outside a Tune trial")
    session.report(merged, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    session = get_session()
    return session.checkpoint_to_restore if session else None
