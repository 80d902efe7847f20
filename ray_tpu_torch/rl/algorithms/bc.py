"""BC — behavior cloning from offline data.

The port of ``ray_tpu/rl/algorithms/bc.py`` (ref: rllib/algorithms/bc/bc.py
BCConfig/BC; loss in rllib/algorithms/bc/torch/bc_torch_learner.py —
negative log-likelihood of the dataset actions under the policy).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.rl_module import Columns
from ray_tpu_torch.rl.offline import OfflineData


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_epochs = 1
        self.minibatch_size = None
        self.entropy_coeff = 0.0
        # offline input
        self.input_: Union[str, Dict, None] = None
        self.input_format = "parquet"
        self.updates_per_iteration = 20

    def offline_data(self, *, input_=None, input_format: Optional[str] = None,
                     updates_per_iteration: Optional[int] = None
                     ) -> "BCConfig":
        """(ref: AlgorithmConfig.offline_data(input_=...))"""
        if input_ is not None:
            self.input_ = input_
        if input_format is not None:
            self.input_format = input_format
        if updates_per_iteration is not None:
            self.updates_per_iteration = updates_per_iteration
        return self


class BCLearner(TorchLearner):
    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out = self.module.forward_train(batch[Columns.OBS])
        inputs = out[Columns.ACTION_DIST_INPUTS]
        dist = self.module.action_dist
        logp = dist.logp(inputs, batch[Columns.ACTIONS])
        loss = -logp.mean()
        coeff = getattr(self.config, "entropy_coeff", 0.0)
        entropy = dist.entropy(inputs).mean()
        if coeff:
            loss = loss - coeff * entropy
        return loss, {"bc_logp": logp.mean(), "entropy": entropy}


class BC(Algorithm):
    """Offline: no env sampling; each iteration runs K learner updates over
    dataset minibatches, syncing weights for evaluation."""

    learner_class = BCLearner
    config_class = BCConfig

    def setup(self, config) -> None:
        super().setup(config)
        cfg = self.algo_config
        if cfg.input_ is None:
            raise ValueError("offline algorithms need .offline_data(input_=...)")
        self.offline = OfflineData(cfg.input_, format=cfg.input_format,
                                   seed=cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        results: Dict[str, Any] = {}
        for _ in range(max(1, cfg.updates_per_iteration)):
            batch = self.offline.sample(cfg.train_batch_size)
            results = self.learner_group.update_from_batch(
                batch, num_epochs=cfg.num_epochs,
                minibatch_size=cfg.minibatch_size)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return {"learners": results, "dataset_size": self.offline.size}
