"""ray_tpu_torch.rl — reinforcement learning library (new-API-stack shape).

The port of ``ray_tpu.rl`` (ref: rllib/ — Algorithm on Tune's Trainable,
EnvRunnerGroup sampling, LearnerGroup updates) in PyTorch: RLModules are
``nn.Module``s, the learner's update runs on the config's device (the card
unless ``device="cpu"``), and several learners all-reduce their gradients
through ``ray_tpu_torch.collective``. The port brings its own CartPole-v1
and Pendulum-v1 (``rl/env/cartpole.py``, ``pendulum.py``), equal to
gymnasium's, so it needs no gymnasium. The algorithms, DreamerV3 among
them, are in ``ray_tpu_torch.rl.algorithms``, as in the reference.
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
from ray_tpu_torch.rl.env.multi_agent_env import MultiAgentCartPole, MultiAgentEnv
from ray_tpu_torch.rl.env.multi_agent_env_runner import MultiAgentEnvRunner
from ray_tpu_torch.rl.env.multi_agent_episode import MultiAgentEpisode
from ray_tpu_torch.rl.offline import OfflineData, record_episodes

__all__ = [
    "Algorithm", "AlgorithmConfig", "TorchLearner", "LearnerGroup", "Columns",
    "DefaultActorCritic", "DefaultQModule", "RLModule", "RLModuleSpec",
    "SingleAgentEnvRunner", "EnvRunnerGroup", "SingleAgentEpisode",
    "MultiAgentEnv", "MultiAgentCartPole", "MultiAgentEnvRunner",
    "MultiAgentEpisode", "MultiRLModule", "MultiRLModuleSpec",
    "OfflineData", "record_episodes",
]
