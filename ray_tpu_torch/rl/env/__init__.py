from ray_tpu_torch.rl.env.env_runner import SingleAgentEnvRunner, env_spaces
from ray_tpu_torch.rl.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rl.env.episode import SingleAgentEpisode

__all__ = ["SingleAgentEnvRunner", "EnvRunnerGroup", "SingleAgentEpisode",
           "env_spaces"]
