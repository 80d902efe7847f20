"""ray_tpu_torch.rl — reinforcement learning library (new-API-stack shape).

The port of ``ray_tpu.rl`` (ref: rllib/ — Algorithm on Tune's Trainable,
EnvRunnerGroup sampling, LearnerGroup updates) in PyTorch: RLModules are
``nn.Module``s, the learner's update runs on the config's device (the card
unless ``device="cpu"``), and several learners all-reduce their gradients
through ``ray_tpu_torch.collective``. The port brings its own CartPole-v1
(``rl/env/cartpole.py``), equal to gymnasium's, so it needs no gymnasium.
Multi-agent RL, the other algorithms and offline RL come with ROADMAP.md
Queue 1 item 12 (b); DreamerV3 with (c).
"""

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.multi_rl_module import MultiRLModule, MultiRLModuleSpec
from ray_tpu_torch.rl.core.rl_module import (Columns, DefaultActorCritic,
                                             DefaultQModule, RLModule, RLModuleSpec)
from ray_tpu_torch.rl.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rl.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rl.env.episode import SingleAgentEpisode

__all__ = [
    "Algorithm", "AlgorithmConfig", "TorchLearner", "LearnerGroup", "Columns",
    "DefaultActorCritic", "DefaultQModule", "RLModule", "RLModuleSpec",
    "SingleAgentEnvRunner", "EnvRunnerGroup", "SingleAgentEpisode",
    "MultiRLModule", "MultiRLModuleSpec",
]
