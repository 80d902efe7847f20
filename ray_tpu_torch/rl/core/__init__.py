from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.core.rl_module import (Columns, DefaultActorCritic,
                                             DefaultQModule, RLModule, RLModuleSpec)

__all__ = ["TorchLearner", "LearnerGroup", "Columns", "DefaultActorCritic",
           "DefaultQModule", "RLModule", "RLModuleSpec"]
