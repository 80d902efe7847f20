"""Experiment-tracking integrations (ref: python/ray/air/integrations/ —
wandb.py, mlflow.py, comet.py).  Each logger is a Tune callback
(on_trial_start/result/complete hooks, tune_controller.py) that forwards
results to its tracking backend; backends not installed in the image fall
back to a local file sink with the same record shape, so experiments are
never silently unlogged.

The counterpart of ``ray_tpu/air/integrations/__init__.py``.
"""

from ray_tpu_torch.air.integrations.mlflow import MLflowLoggerCallback, setup_mlflow
from ray_tpu_torch.air.integrations.tensorboard import TBXLoggerCallback
from ray_tpu_torch.air.integrations.wandb import WandbLoggerCallback, setup_wandb

__all__ = ["MLflowLoggerCallback", "TBXLoggerCallback",
           "WandbLoggerCallback", "setup_mlflow", "setup_wandb"]
