"""Connector pipelines — episodes → train batch.

(ref: rllib/connectors/ — env_to_module/, learner/, module_to_env/ pipelines;
the learner pipeline's GAE piece lives in
rllib/connectors/learner/general_advantage_estimation.py.)

The port of ``ray_tpu/rl/connectors.py``. Host-side data munging stays in
numpy (it is control-plane glue, not device work); anything
per-minibatch-hot lives inside the learner's update on its device. The
value function GAE calls returns a tensor on the learner's device, which
comes to the host once per call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.rl.core.rl_module import Columns
from ray_tpu_torch.rl.env.episode import SingleAgentEpisode


class ConnectorPipeline:
    """Ordered list of callables batch=fn(batch, episodes)."""

    def __init__(self, connectors: Optional[Sequence[Callable]] = None):
        self.connectors: List[Callable] = list(connectors or [])

    def append(self, connector: Callable) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def __call__(self, batch: Dict[str, Any], episodes: List[SingleAgentEpisode],
                 **kw) -> Dict[str, Any]:
        for c in self.connectors:
            batch = c(batch, episodes, **kw)
        return batch


def batch_episodes(batch: Dict[str, Any], episodes: List[SingleAgentEpisode],
                   **kw) -> Dict[str, Any]:
    """Default learner connector head: concatenate per-step columns.

    obs excludes each episode's final observation (it has no action); the
    final obs is kept separately for bootstrapping.
    """
    obs, actions, rewards, logp, terms, eps_bounds, last_obs = \
        [], [], [], [], [], [], []
    start = 0
    for ep in episodes:
        T = len(ep)
        arr = ep.to_numpy()
        obs.append(arr["obs"][:-1])
        last_obs.append(arr["obs"][-1])
        actions.append(arr["actions"])
        rewards.append(arr["rewards"])
        if Columns.ACTION_LOGP in arr:
            logp.append(arr[Columns.ACTION_LOGP])
        terms.append(ep.is_terminated)
        eps_bounds.append((start, start + T))
        start += T
    batch = dict(batch)
    batch[Columns.OBS] = np.concatenate(obs).astype(np.float32)
    batch[Columns.ACTIONS] = np.concatenate(actions)
    batch[Columns.REWARDS] = np.concatenate(rewards).astype(np.float32)
    if logp:
        batch[Columns.ACTION_LOGP] = np.concatenate(logp).astype(np.float32)
    batch["_eps_bounds"] = eps_bounds
    batch["_eps_terminated"] = terms
    batch["_last_obs"] = np.stack(last_obs).astype(np.float32)
    return batch


def _to_host(values) -> np.ndarray:
    """A value function's output (a tensor on any device, or an array) as
    a numpy array: one copy to the host."""
    if hasattr(values, "detach"):
        return values.detach().cpu().numpy()
    return np.asarray(values)


class GeneralAdvantageEstimation:
    """GAE(λ) learner connector (ref: rllib/connectors/learner/
    general_advantage_estimation.py — runs the module's value head over the
    episodes, computes advantages + value targets)."""

    def __init__(self, gamma: float = 0.99, lambda_: float = 0.95,
                 normalize_advantages: bool = True):
        self.gamma = gamma
        self.lambda_ = lambda_
        self.normalize = normalize_advantages

    def __call__(self, batch: Dict[str, Any], episodes, *, module=None,
                 params=None, vf_fn=None, **kw) -> Dict[str, Any]:
        if vf_fn is None:
            raise ValueError("GAE needs the learner's value fn (vf_fn=)")
        values = _to_host(vf_fn(params, batch[Columns.OBS]))
        bootstrap = _to_host(vf_fn(params, batch["_last_obs"]))
        advantages = np.zeros_like(batch[Columns.REWARDS])
        vtargets = np.zeros_like(advantages)
        for i, (s, e) in enumerate(batch["_eps_bounds"]):
            v_next = 0.0 if batch["_eps_terminated"][i] else float(bootstrap[i])
            lastgaelam = 0.0
            for t in range(e - 1, s - 1, -1):
                delta = (batch[Columns.REWARDS][t] + self.gamma * v_next
                         - values[t])
                lastgaelam = delta + self.gamma * self.lambda_ * lastgaelam
                advantages[t] = lastgaelam
                v_next = values[t]
            vtargets[s:e] = advantages[s:e] + values[s:e]
        if self.normalize and len(advantages) > 1:
            advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        batch[Columns.ADVANTAGES] = advantages.astype(np.float32)
        batch[Columns.VALUE_TARGETS] = vtargets.astype(np.float32)
        batch[Columns.VF_PREDS] = values.astype(np.float32)
        return batch


def strip_internal(batch: Dict[str, Any], episodes=None, **kw) -> Dict[str, Any]:
    """Drop host-side bookkeeping columns before the learner's update."""
    return {k: v for k, v in batch.items() if not k.startswith("_")}


def episodes_to_transitions(episodes: List[SingleAgentEpisode]) -> Dict[str, np.ndarray]:
    """(obs, action, reward, next_obs, done) rows for replay buffers (DQN)."""
    obs, actions, rewards, next_obs, dones, truncs = [], [], [], [], [], []
    for ep in episodes:
        arr = ep.to_numpy()
        T = len(ep)
        obs.append(arr["obs"][:-1])
        next_obs.append(arr["obs"][1:])
        actions.append(arr["actions"])
        rewards.append(arr["rewards"])
        d = np.zeros(T, np.float32)
        if ep.is_terminated:
            d[-1] = 1.0
        dones.append(d)
        # Truncation marks an episode BOUNDARY without a terminal state —
        # offline consumers (MARWIL returns-to-go) must not let value
        # bootstraps/returns bleed across it.
        t = np.zeros(T, np.float32)
        if ep.is_truncated:
            t[-1] = 1.0
        truncs.append(t)
    return {
        Columns.OBS: np.concatenate(obs).astype(np.float32),
        Columns.ACTIONS: np.concatenate(actions),
        Columns.REWARDS: np.concatenate(rewards).astype(np.float32),
        Columns.NEXT_OBS: np.concatenate(next_obs).astype(np.float32),
        Columns.TERMINATEDS: np.concatenate(dones),
        Columns.TRUNCATEDS: np.concatenate(truncs),
    }
