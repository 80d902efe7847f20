"""PPO; the other algorithms come with ROADMAP.md Queue 1 item 12 (b) and
(c)."""

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig, PPOLearner

__all__ = ["PPO", "PPOConfig", "PPOLearner"]
