"""IMPALA — async actor-learner with V-trace off-policy correction.

The port of ``ray_tpu/rl/algorithms/impala.py`` (ref: rllib/algorithms/
impala/impala.py:135-197 — async sample fan-out with in-flight request
tracking + AggregatorActors; V-trace loss in rllib/algorithms/impala/torch/
impala_torch_learner.py, vtrace math in rllib/algorithms/impala/torch/
vtrace_torch.py; Espeholt et al. 2018).

The env runners sample continuously (``max_requests_in_flight_per_env_runner``
requests each); the driver drains whichever finish first
(``ray_tpu_torch.wait``), batches fragments into (B, T) rows, and updates the
learner while the next samples are already running — behaviour log-probs
ride along for the V-trace correction. ``vtrace`` runs over the (B, T) rows
at once, a loop over T from the tail (the reference vmaps a ``lax.scan``
over the fragments). With aggregator actors the weight broadcast is
fire-and-forget: ``EnvRunnerGroup.sync_weights`` snapshots the learner's
weights into host tensors before it returns, so the learner's next in-place
step cannot reach what the runners sample with.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.ppo import make_vf_fn
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.core.learner import TorchLearner
from ray_tpu_torch.rl.core.rl_module import Columns


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.lr = 5e-4
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_pg_rho_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rollout_fragment_length = 50
        self.train_batch_size = 500
        self.num_epochs = 1
        self.minibatch_size = None
        self.broadcast_interval = 1  # weight sync every N updates
        self.max_requests_in_flight_per_env_runner = 2
        #: Aggregation actors between runners and learner (ref:
        #: impala.py:135-197 AggregatorActor): fragments are stitched into
        #: train batches OFF the learner loop, and weight broadcasts go
        #: async — the driver only routes refs.  0 = aggregate inline.
        self.num_aggregator_actors = 0


def vtrace(behavior_logp: torch.Tensor, target_logp: torch.Tensor,
           rewards: torch.Tensor, values: torch.Tensor,
           bootstrap_value: torch.Tensor, discounts: torch.Tensor,
           clip_rho: float = 1.0, clip_pg_rho: float = 1.0, mask=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets and policy-gradient advantages over (B, T) rows,
    ``bootstrap_value`` (B,) (ref: vtrace_torch.py multi_from_logits,
    single-agent form): a loop over T from the tail. ``mask`` zeroes padded
    steps' deltas so they cannot perturb real steps."""
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    cs = torch.clamp(rhos, max=1.0)
    values_next = torch.cat([values[:, 1:], bootstrap_value[:, None]], dim=1)
    deltas = clipped_rhos * (rewards + discounts * values_next - values)
    if mask is not None:
        deltas = deltas * mask
    acc = torch.zeros_like(bootstrap_value)
    out = []
    for t in range(rewards.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
        out.append(acc)
    vs = values + torch.stack(out[::-1], dim=1)
    vs_next = torch.cat([vs[:, 1:], bootstrap_value[:, None]], dim=1)
    pg_rhos = torch.clamp(rhos, max=clip_pg_rho)
    pg_advantages = pg_rhos * (rewards + discounts * vs_next - values)
    return vs, pg_advantages


class IMPALALearner(TorchLearner):
    def _vtrace_terms(self, batch: Dict[str, torch.Tensor]):
        """Shared V-trace machinery (also the base of APPO's loss): forward
        pass, masked normalizer, V-trace over the fragment rows on detached
        inputs (the reference's ``stop_gradient`` on its outputs). Padded
        steps have discount 0 AND masked deltas, so nothing leaks backward
        into real steps."""
        cfg = self.config
        out = self.module.forward_train(batch[Columns.OBS])
        dist = self.module.action_dist
        inputs = out[Columns.ACTION_DIST_INPUTS]
        target_logp = dist.logp(inputs, batch[Columns.ACTIONS])
        values = out[Columns.VF_PREDS]
        mask = batch["mask"]
        denom = torch.clamp(mask.sum(), min=1.0)
        with torch.no_grad():
            vs, pg_adv = vtrace(
                batch[Columns.ACTION_LOGP], target_logp, batch[Columns.REWARDS],
                values, batch["bootstrap_value"], batch["discounts"],
                cfg.vtrace_clip_rho_threshold,
                cfg.vtrace_clip_pg_rho_threshold, mask=mask)
        return dist, inputs, target_logp, values, mask, denom, vs, pg_adv

    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        (dist, inputs, target_logp, values, mask, denom, vs, pg_adv) = \
            self._vtrace_terms(batch)
        policy_loss = -(target_logp * pg_adv * mask).sum() / denom
        value_loss = 0.5 * (torch.square(values - vs) * mask).sum() / denom
        entropy = (dist.entropy(inputs) * mask).sum() / denom
        total = (policy_loss + cfg.vf_loss_coeff * value_loss
                 - cfg.entropy_coeff * entropy)
        return total, {"policy_loss": policy_loss, "vf_loss": value_loss,
                       "entropy": entropy}


def build_vtrace_batch(episodes, T: int, gamma: float) -> Dict[str, np.ndarray]:
    """Chunk fragments into (B, T) rows for V-trace.

    Fragments longer than T are SPLIT into multiple rows (never discarded);
    short rows are zero-padded and masked out of the loss. Module-level so
    aggregation actors run it off the learner loop (ref: impala.py:135-197
    AggregatorActor)."""
    cols: Dict[str, List] = {k: [] for k in
                             (Columns.OBS, Columns.ACTIONS, Columns.REWARDS,
                              Columns.ACTION_LOGP, "discounts", "mask",
                              "bootstrap_obs", "bootstrap_terminated")}
    for ep in episodes:
        arr = ep.to_numpy()
        t = len(ep)
        for start in range(0, t, T):
            end = min(start + T, t)
            n = end - start
            pad = T - n

            def padded(x, value=0.0):
                x = x[start:end]
                if pad:
                    x = np.concatenate([x, np.full((pad, *x.shape[1:]),
                                                   value, x.dtype)])
                return x

            cols[Columns.OBS].append(padded(arr["obs"][:-1]))
            cols[Columns.ACTIONS].append(padded(arr["actions"]))
            cols[Columns.REWARDS].append(padded(arr["rewards"]))
            cols[Columns.ACTION_LOGP].append(padded(arr[Columns.ACTION_LOGP]))
            terminal_chunk = ep.is_terminated and end == t
            disc = np.full(n, gamma, np.float32)
            if terminal_chunk:
                disc[-1] = 0.0
            if pad:
                disc = np.concatenate([disc, np.zeros(pad, np.float32)])
            cols["discounts"].append(disc)
            mask = np.concatenate([np.ones(n, np.float32),
                                   np.zeros(pad, np.float32)])
            cols["mask"].append(mask)
            cols["bootstrap_obs"].append(arr["obs"][end])
            cols["bootstrap_terminated"].append(
                1.0 if terminal_chunk else 0.0)
    return {k: np.stack(v).astype(np.float32) if k != Columns.ACTIONS
            else np.stack(v)
            for k, v in cols.items()}


class BatchAggregator:
    """Aggregation actor: buffers episode fragments, emits a train batch
    once enough steps accumulated (ref: impala.py:135-197 AggregatorActor +
    aggregator_actor.py — the tier that keeps episode stitching off the
    learner loop)."""

    def __init__(self, T: int, gamma: float, train_batch_size: int):
        self._T = T
        self._gamma = gamma
        self._target = train_batch_size
        self._buf: List[Any] = []
        self._steps = 0

    def add(self, episodes) -> Any:
        """Returns a ready (B, T) batch dict, or None while accumulating."""
        live = [ep for ep in episodes if len(ep) > 0]
        self._buf.extend(live)
        self._steps += sum(len(ep) for ep in live)
        if self._steps < self._target:
            return None
        episodes, self._buf, self._steps = self._buf, [], 0
        return build_vtrace_batch(episodes, self._T, self._gamma)


def _mean_of_batches(per_batch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Mean over one step's updates — returning only the last batch would
    bias reported losses toward a subsample. A metric only some batches
    reported averages over those; a non-scalar one passes its last value
    through, so the key's schema stays stable."""
    if len(per_batch) <= 1:
        return per_batch[0] if per_batch else {}
    results: Dict[str, Any] = {}
    for k in set().union(*per_batch):
        vals = []
        for r in per_batch:
            try:
                vals.append(float(r[k]))
            except (KeyError, TypeError, ValueError):
                pass
        if vals:
            results[k] = float(np.mean(vals))
        else:
            results[k] = next(r[k] for r in reversed(per_batch) if k in r)
    return results


class IMPALA(Algorithm):
    learner_class = IMPALALearner
    config_class = IMPALAConfig

    def setup(self, config) -> None:
        super().setup(config)
        cfg = self.algo_config
        self._inflight: Dict[Any, Any] = {}  # ref -> runner
        self._updates = 0
        self._aggregators: List[Any] = []
        self._agg_rr = 0
        self._pending_batches: List[Any] = []
        if cfg.num_aggregator_actors and self.env_runner_group.runners:
            agg_cls = ray_tpu_torch.remote(BatchAggregator)
            self._aggregators = [
                agg_cls.remote(cfg.rollout_fragment_length, cfg.gamma,
                               cfg.train_batch_size)
                for _ in range(cfg.num_aggregator_actors)]

    def _batch_from_episodes(self, episodes) -> Dict[str, np.ndarray]:
        cfg = self.algo_config
        return build_vtrace_batch(episodes, cfg.rollout_fragment_length,
                                  cfg.gamma)

    def cleanup(self) -> None:
        for agg in self._aggregators:
            try:
                ray_tpu_torch.kill(agg)
            except Exception:  # noqa: BLE001 — a dead aggregator is gone
                pass
        self._aggregators = []
        super().cleanup()

    def _saturate_runners(self) -> None:
        """Keep every runner loaded with in-flight sample requests."""
        cfg = self.algo_config
        runners = self.env_runner_group.runners
        per = max(cfg.rollout_fragment_length,
                  cfg.train_batch_size // len(runners))
        for r in runners:
            inflight_for_r = sum(1 for v in self._inflight.values() if v is r)
            while inflight_for_r < cfg.max_requests_in_flight_per_env_runner:
                self._inflight[r.sample.remote(num_timesteps=per)] = r
                inflight_for_r += 1

    def training_step(self) -> Dict[str, Any]:
        runners = self.env_runner_group.runners
        if not runners:
            # Synchronous fallback (num_env_runners=0): plain on-policy step.
            episodes = self._sample_batch()
            return {"learners": self._learn(episodes)}
        self._saturate_runners()
        if self._aggregators:
            return self._aggregated_step()

        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                      timeout=30.0)
        episodes = []
        for ref in ready:
            self._inflight.pop(ref, None)
            episodes.extend(ray_tpu_torch.get(ref))
        self._lifetime_steps += sum(len(ep) for ep in episodes)
        return {"learners": self._learn(episodes),
                "num_inflight_requests": len(self._inflight)}

    def _aggregated_step(self) -> Dict[str, Any]:
        """Aggregator pipeline: the driver only ROUTES refs — finished
        sample refs go to aggregation actors (round-robin), ready batches
        go to the learner, weight broadcasts are fire-and-forget (ref:
        impala.py:135-197 — sampling, aggregation and learning overlap)."""
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                      timeout=30.0)
        # Drain EVERY completed ref, not just the first: undrained refs
        # count toward the in-flight cap, so leaving them parked while a
        # learner update runs stalls the runners the cap governs.
        more, _ = ray_tpu_torch.wait(list(self._inflight),
                                     num_returns=len(self._inflight), timeout=0)
        for ref in dict.fromkeys(list(ready) + list(more)):
            if self._inflight.pop(ref, None) is None:
                continue
            agg = self._aggregators[self._agg_rr % len(self._aggregators)]
            self._agg_rr += 1
            # The episode payload flows runner -> aggregator; the driver
            # never materializes it.
            self._pending_batches.append(agg.add.remote(ref))
        self._saturate_runners()  # samplers never idle while we learn

        per_batch: List[Dict[str, Any]] = []
        if self._pending_batches:
            done, self._pending_batches = ray_tpu_torch.wait(
                self._pending_batches,
                num_returns=len(self._pending_batches), timeout=0.02)
            for bref in done:
                batch = ray_tpu_torch.get(bref)
                if batch is None:
                    continue  # aggregator still accumulating
                self._lifetime_steps += int(batch["mask"].sum())
                per_batch.append(self._learn_from_batch(batch))
        return {"learners": _mean_of_batches(per_batch),
                "num_inflight_requests": len(self._inflight),
                "num_pending_agg_batches": len(self._pending_batches),
                "num_batches_learned": len(per_batch)}

    def _learn(self, episodes) -> Dict[str, Any]:
        episodes = [ep for ep in episodes if len(ep) > 0]
        if not episodes:
            return {}
        return self._learn_from_batch(self._batch_from_episodes(episodes))

    def _learn_from_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        cfg = self.algo_config
        # Bootstrap values from the current weights: the local learner's
        # own module, or a driver copy run with learner 0's weights.
        local = self.learner_group._local
        if not hasattr(self, "_vf_fn"):
            self._vf_fn = make_vf_fn(
                local.module if local is not None
                else self.module_spec.build(device=self.device))
        params = None if local is not None else self.learner_group.get_weights()
        bv = self._vf_fn(params, batch.pop("bootstrap_obs")).cpu().numpy()
        batch["bootstrap_value"] = (bv * (1.0 - batch.pop("bootstrap_terminated"))
                                    ).astype(np.float32)
        batch = self._augment_batch(batch)  # subclass hook (APPO's kl_coeff)
        results = self.learner_group.update_from_batch(
            batch, num_epochs=cfg.num_epochs)
        self._after_learn(results)
        self._updates += 1
        if self._updates % cfg.broadcast_interval == 0:
            # Fire-and-forget under the aggregator pipeline: actor mailbox
            # order guarantees a runner applies the weights before its next
            # sample call; blocking would stall the learner loop.
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights(),
                block=not self._aggregators)
        return results

    def _augment_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return batch

    def _after_learn(self, results: Dict[str, Any]) -> None:
        pass
