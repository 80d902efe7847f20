from ray_tpu_torch.rl.utils.metrics import MetricsLogger
from ray_tpu_torch.rl.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer

__all__ = ["MetricsLogger", "ReplayBuffer", "PrioritizedReplayBuffer"]
