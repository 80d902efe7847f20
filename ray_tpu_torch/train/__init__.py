"""ray_tpu_torch.train — distributed training library (the counterpart of
``ray_tpu.train``; ref: python/ray/train).

``CudaTrainer`` takes the place of ``JaxTrainer``.
"""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    DatasetConfig,
    ElasticConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.elastic import ElasticDatasetShard, SampleLedger
from ray_tpu_torch.train.profiler import StepProfiler, active_profiler
from ray_tpu_torch.train.profiler import configure as configure_profiler
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_dataset_config,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.torch_trainer import TorchTrainer
from ray_tpu_torch.train.trainer import CudaTrainer, DataParallelTrainer, Result

__all__ = [
    "Checkpoint", "CheckpointManager", "CheckpointConfig", "CudaTrainer",
    "DataParallelTrainer", "DatasetConfig", "ElasticConfig",
    "ElasticDatasetShard", "FailureConfig",
    "Result", "RunConfig", "SampleLedger", "ScalingConfig", "StepProfiler",
    "active_profiler", "configure_profiler",
    "get_checkpoint", "get_context", "get_dataset_config",
    "get_dataset_shard", "load_pytree",
    "report", "save_pytree", "TorchTrainer",
]
