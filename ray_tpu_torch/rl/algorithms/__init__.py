"""The RL algorithms: PPO, DQN, IMPALA, APPO, SAC, CQL, BC, MARWIL and
DreamerV3 (model-based, trained in imagination)."""

from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig, APPOLearner
from ray_tpu_torch.rl.algorithms.bc import BC, BCConfig, BCLearner
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig, CQLLearner
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig, DQNLearner
from ray_tpu_torch.rl.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rl.algorithms.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rl.algorithms.marwil import MARWIL, MARWILConfig, MARWILLearner
from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig, SACLearner

__all__ = ["APPO", "APPOConfig", "APPOLearner",
           "PPO", "PPOConfig", "PPOLearner", "DQN", "DQNConfig", "DQNLearner",
           "IMPALA", "IMPALAConfig", "IMPALALearner",
           "SAC", "SACConfig", "SACLearner", "BC", "BCConfig", "BCLearner",
           "CQL", "CQLConfig", "CQLLearner",
           "MARWIL", "MARWILConfig", "MARWILLearner",
           "DreamerV3", "DreamerV3Config"]
