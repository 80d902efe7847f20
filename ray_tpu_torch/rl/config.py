"""AlgorithmConfig — fluent builder.

The port of ``ray_tpu/rl/config.py`` (ref: rllib/algorithms/
algorithm_config.py:103 AlgorithmConfig — chained .environment()/
.env_runners()/.training()/.learners()/.evaluation() setters,
``build_algo()``, and dict round-trip for Tune param_space merging).

One field more than the reference: ``device``, where the learners, the env
runners' forward and GAE's value pass run. ``None`` is the card (and
raises without one); the tests pass ``"cpu"``. ``.resources(device=...)``
sets it. Multi-agent configs come with ROADMAP.md Queue 1 item 12 (b).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.rl.core.rl_module import DefaultActorCritic, RLModuleSpec

MULTI_AGENT_TODO = ("multi-agent RL (MultiAgentEnvRunner, per-policy "
                    "learner groups) is not ported yet: ROADMAP.md, Queue 1 "
                    "item 12 (b)")


class AlgorithmConfig:
    algo_class: Optional[type] = None  # set by subclasses

    def __init__(self, algo_class: Optional[type] = None):
        if algo_class is not None:
            self.algo_class = algo_class
        # environment
        self.env: Union[str, Callable, None] = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 200
        self.explore = True
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.grad_clip: Optional[float] = None
        self.train_batch_size = 4000
        self.minibatch_size: Optional[int] = 128
        self.num_epochs = 1
        self.model: Dict[str, Any] = {}
        self.module_class: type = DefaultActorCritic
        # learners
        self.num_learners = 0
        # multi-agent (ref: algorithm_config.py multi_agent(policies=...,
        # policy_mapping_fn=...)); see MULTI_AGENT_TODO
        self.policies: Optional[Dict[str, Optional[RLModuleSpec]]] = None
        # resources: the learners' and the runners' device
        self.device: DeviceLike = None
        # debug / misc
        self.seed = 0
        self.evaluation_interval: Optional[int] = None
        self.evaluation_duration = 5  # episodes

    # ------------------------------------------------------------- setters
    def environment(self, env=None, *, env_config: Optional[Dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    explore: Optional[bool] = None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if explore is not None:
            self.explore = explore
        return self

    def training(self, **kwargs: Any) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"Unknown training config key: {k}")
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def resources(self, *, device: DeviceLike = None) -> "AlgorithmConfig":
        """The device of the learners, the runners' forward and GAE's value
        pass (``None``: the card)."""
        self.device = device
        return self

    def rl_module(self, *, module_class: Optional[type] = None,
                  model_config: Optional[Dict] = None) -> "AlgorithmConfig":
        if module_class is not None:
            self.module_class = module_class
        if model_config is not None:
            self.model = dict(model_config)
        return self

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Callable[[str], str]] = None
                    ) -> "AlgorithmConfig":
        """(ref: algorithm_config.py:multi_agent) Not ported yet."""
        raise NotImplementedError(MULTI_AGENT_TODO)

    def is_multi_agent(self) -> bool:
        return bool(self.policies)

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # ------------------------------------------------------------- build
    def module_spec(self) -> RLModuleSpec:
        from ray_tpu_torch.rl.env.env_runner import env_spaces

        obs_dim, act_dim, discrete = env_spaces(self.env, self.env_config)
        return RLModuleSpec(module_class=self.module_class,
                            observation_dim=obs_dim, action_dim=act_dim,
                            discrete=discrete, model_config=dict(self.model))

    def build_algo(self):
        if self.algo_class is None:
            raise ValueError("config has no algo_class bound")
        return self.algo_class(config=self)

    # alias kept for reference API parity
    build = build_algo

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    # ------------------------------------------------------------- dict io
    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            if k == "env":
                self.env = v
            elif hasattr(self, k):
                setattr(self, k, v)
            else:
                raise AttributeError(f"Unknown config key: {k}")
        return self
