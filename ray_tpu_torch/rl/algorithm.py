"""Algorithm — the RL control loop, a Tune Trainable.

The port of ``ray_tpu/rl/algorithm.py`` (ref: rllib/algorithms/
algorithm.py:227 Algorithm(Trainable) — step:973 calls training_step:1780;
sampling via EnvRunnerGroup fan-out, learning via LearnerGroup, weight sync
back to runners; save/restore through the Checkpointable contract), on the
port's ``tune.trainable.Trainable``. The device is resolved first, so an
algorithm without a card raises before it builds anything unless its config
says ``device="cpu"``. Checkpoints hold host copies of the learner's state
dict and optimizer state.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.config import MULTI_AGENT_TODO, AlgorithmConfig
from ray_tpu_torch.rl.connectors import ConnectorPipeline, batch_episodes
from ray_tpu_torch.rl.core.learner_group import LearnerGroup
from ray_tpu_torch.rl.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rl.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rl.utils.metrics import MetricsLogger
from ray_tpu_torch.tune.trainable import Trainable

ENV_RUNNER_RESULTS = "env_runners"
LEARNER_RESULTS = "learners"
EPISODE_RETURN_MEAN = "episode_return_mean"
NUM_ENV_STEPS_SAMPLED_LIFETIME = "num_env_steps_sampled_lifetime"


class Algorithm(Trainable):
    """Base algorithm; subclasses bind a learner class + connector pipeline."""

    learner_class: type = None
    config_class = AlgorithmConfig

    # -------------------------------------------------------------- setup
    @classmethod
    def _coerce_config(cls, config) -> AlgorithmConfig:
        """Tune passes plain dicts (param_space), users pass configs —
        one resolution path shared by every algorithm's setup."""
        if isinstance(config, AlgorithmConfig):
            return config
        cfg = cls.config_class()
        base = config.pop("_base_config", None)
        if base is not None:
            cfg = base.copy()
        cfg.update_from_dict(config)
        return cfg

    def setup(self, config: Dict[str, Any]) -> None:
        cfg = self._coerce_config(config)
        self.algo_config = cfg
        self.device = resolve_device(cfg.device)
        if cfg.is_multi_agent():
            raise NotImplementedError(MULTI_AGENT_TODO)
        self.metrics = MetricsLogger()
        self.learner_connector = self.build_learner_connector()
        self._lifetime_steps = 0
        self.module_spec = cfg.module_spec()
        self.env_runner_group = EnvRunnerGroup(
            env=cfg.env, env_config=cfg.env_config,
            module_spec=self.module_spec,
            num_env_runners=cfg.num_env_runners,
            num_envs_per_env_runner=cfg.num_envs_per_env_runner,
            rollout_fragment_length=cfg.rollout_fragment_length,
            explore=cfg.explore, seed=cfg.seed, device=self.device)
        self.learner_group = LearnerGroup(
            learner_class=type(self).learner_class, config=cfg,
            module_spec=self.module_spec, num_learners=cfg.num_learners,
            seed=cfg.seed)
        # Initial weight alignment: runners start from learner params.
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def build_learner_connector(self) -> ConnectorPipeline:
        return ConnectorPipeline([batch_episodes])

    # --------------------------------------------------------------- step
    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step()
        for runner_metrics in self.env_runner_group.get_metrics():
            if runner_metrics.get("num_episodes", 0) > 0:
                self.metrics.log_dict(runner_metrics, key=ENV_RUNNER_RESULTS,
                                      window=20)
        env_results = self.metrics.reduce(ENV_RUNNER_RESULTS)
        result.setdefault(ENV_RUNNER_RESULTS, {}).update(env_results)
        result[NUM_ENV_STEPS_SAMPLED_LIFETIME] = self._lifetime_steps
        # Flat convenience mirror used by Tune metric= strings.
        if EPISODE_RETURN_MEAN in env_results:
            result[EPISODE_RETURN_MEAN] = env_results[EPISODE_RETURN_MEAN]
        result["time_this_iter_s"] = time.time() - t0
        cfg = self.algo_config
        if cfg.evaluation_interval and self.iteration % cfg.evaluation_interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # ---------------------------------------------------------- evaluation
    def evaluate(self) -> Dict[str, Any]:
        """Greedy-policy evaluation on a DEDICATED runner (ref: algorithm.py
        evaluate() on eval_env_runner_group).  Training runners must not be
        touched: eval steps would extend their in-progress episodes and feed
        greedy actions (with wrong behavior logps) into the next train batch.
        """
        cfg = self.algo_config
        if not hasattr(self, "_eval_runner"):
            self._eval_runner = SingleAgentEnvRunner(
                env=cfg.env, env_config=cfg.env_config,
                module_spec=self.module_spec,
                num_envs=cfg.num_envs_per_env_runner,
                rollout_fragment_length=cfg.rollout_fragment_length,
                explore=False, seed=cfg.seed + 10_000, worker_index=999,
                device=self.device)
        self._eval_runner.set_state({"params": self.get_weights()})
        # Fresh episodes every round: a trajectory must not span two policies.
        self._eval_runner.reset()
        episodes = self._eval_runner.sample(
            num_episodes=cfg.evaluation_duration, explore=False)
        returns = [ep.total_return for ep in episodes if ep.is_done]
        if not returns:
            return {}
        return {ENV_RUNNER_RESULTS: {
            EPISODE_RETURN_MEAN: float(np.mean(returns)),
            "num_episodes": len(returns),
        }}

    # -------------------------------------------------------- checkpointing
    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        state = {
            "learner": self.learner_group.get_state(),
            "lifetime_steps": self._lifetime_steps,
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)
        return None

    def load_checkpoint(self, data, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._lifetime_steps = state.get("lifetime_steps", 0)

    def cleanup(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.stop()
        if hasattr(self, "_eval_runner"):
            self._eval_runner.stop()

    # ------------------------------------------------------------- helpers
    def get_weights(self):
        return self.learner_group.get_weights()

    def _sample_batch(self):
        cfg = self.algo_config
        episodes = self.env_runner_group.sample(
            num_timesteps=cfg.train_batch_size)
        self._lifetime_steps += sum(
            getattr(ep, "total_env_steps", None) or len(ep)
            for ep in episodes)
        return episodes


class _SingleRunnerGroup:
    """EnvRunnerGroup-shaped adapter over one local runner (the multi-agent
    path of ROADMAP.md Queue 1 item 12 (b); fan-out over remote multi-agent
    runners composes later the same way EnvRunnerGroup wraps
    SingleAgentEnvRunner)."""

    def __init__(self, runner):
        self.runner = runner

    def sample(self, **kw):
        return self.runner.sample(**kw)

    def sync_weights(self, weights) -> None:
        self.runner.set_state({"params": weights})

    def get_metrics(self) -> List[Dict[str, Any]]:
        return [self.runner.get_metrics()]

    def stop(self) -> None:
        self.runner.stop()
