"""EnvRunnerGroup — fan-out over remote env-runner actors.

The port of ``ray_tpu/rl/env/env_runner_group.py`` (ref: rllib/env/
env_runner_group.py:71 EnvRunnerGroup — manages N remote EnvRunner actors +
an optional local one; foreach_env_runner fan-out, sync_weights, restart
of failed runners). Remote runners are ``ray_tpu_torch`` actors.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.rl.core.learner import host_copy
from ray_tpu_torch.rl.env.env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(self, *, env, env_config, module_spec, num_env_runners: int,
                 num_envs_per_env_runner: int, rollout_fragment_length: int,
                 explore: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        self._runner_kwargs = dict(
            env=env, env_config=env_config, module_spec=module_spec,
            num_envs=num_envs_per_env_runner,
            rollout_fragment_length=rollout_fragment_length,
            explore=explore, seed=seed, device=device,
        )
        self.num_env_runners = num_env_runners
        self._local_runner: Optional[SingleAgentEnvRunner] = None
        self._remote_runners: List[Any] = []
        self._pending_sync: Optional[List[Any]] = None
        self._unsettled: List[Any] = []
        self.sync_failures = 0
        if num_env_runners == 0:
            self._local_runner = SingleAgentEnvRunner(worker_index=0,
                                                      **self._runner_kwargs)
        else:
            cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
            self._remote_runners = [
                cls.remote(worker_index=i + 1, **self._runner_kwargs)
                for i in range(num_env_runners)
            ]

    # ------------------------------------------------------------------
    def sample(self, *, num_timesteps: Optional[int] = None,
               num_episodes: Optional[int] = None,
               random_actions: bool = False,
               explore: Optional[bool] = None) -> List:
        """Synchronous fan-out sample (ref: algorithm.py:1814
        synchronous_parallel_sample)."""
        if self._local_runner is not None:
            return self._local_runner.sample(
                num_timesteps=num_timesteps, num_episodes=num_episodes,
                random_actions=random_actions, explore=explore)
        n = len(self._remote_runners)
        refs = []
        for i, r in enumerate(self._remote_runners):
            # Spread the remainder over the first runners so the totals add
            # up to exactly num_timesteps / num_episodes.
            per_ts = per_eps = None
            if num_timesteps is not None:
                per_ts = num_timesteps // n + (1 if i < num_timesteps % n else 0)
            if num_episodes is not None:
                per_eps = num_episodes // n + (1 if i < num_episodes % n else 0)
            if per_ts == 0 or per_eps == 0:
                continue
            refs.append(r.sample.remote(num_timesteps=per_ts,
                                        num_episodes=per_eps,
                                        random_actions=random_actions,
                                        explore=explore))
        episodes: List = []
        for chunk in ray_tpu_torch.get(refs):
            episodes.extend(chunk)
        return episodes

    # ------------------------------------------------------------------
    def sync_weights(self, params: Any, block: bool = True) -> None:
        """Push learner params to every runner (ref: env_runner_group.py
        sync_weights). A local runner copies them into its own parameters
        at once; for remote runners the params are snapshot ONCE per
        broadcast into host tensors before the fan-out, since an actor call
        holds its arguments by reference until the runner runs it.
        ``block=False`` is the async-pipeline mode: actor mailbox ordering
        still applies the weights before the runner's next sample call, but
        the caller doesn't stall on the round-trip."""
        if self._local_runner is not None:
            self._local_runner.set_state({"params": params})
            return
        params = host_copy(params)
        refs = [r.set_state.remote({"params": params})
                for r in self._remote_runners]
        if block:
            ray_tpu_torch.get(refs)
            return
        # Double-buffered: hold this broadcast's refs and settle the
        # PREVIOUS one (usually done by now — mailbox order), so dropped
        # refs never race their own result into an unfreeable store entry.
        # Settling is non-blocking (wait timeout=0): one wedged runner must
        # not stall the fire-and-forget learner loop; unfinished refs carry
        # forward with a deadline instead.
        prev = self._pending_sync
        self._pending_sync = refs
        if prev:
            self._unsettled.extend((r, time.monotonic() + 10.0) for r in prev)
        self._sweep_unsettled()

    def _sweep_unsettled(self) -> None:
        still = []
        failed = 0
        for ref, deadline in self._unsettled:
            done, _ = ray_tpu_torch.wait([ref], timeout=0)
            if done:
                try:
                    ray_tpu_torch.get(ref)
                except Exception as e:  # noqa: BLE001 — counted and reported
                    failed += 1
                    print(f"[env_runner_group] weight broadcast failed: "
                          f"{e!r}", file=sys.stderr, flush=True)
            elif time.monotonic() > deadline:
                # A runner that can't apply weights samples with STALE
                # params forever — surface it instead of silently eating it.
                failed += 1
                print("[env_runner_group] weight broadcast unacknowledged "
                      "for 10s (wedged runner?)", file=sys.stderr, flush=True)
            else:
                still.append((ref, deadline))
        self._unsettled = still
        if failed:
            self.sync_failures += failed
            if self.sync_failures >= 3 * max(1, len(self._remote_runners)):
                raise RuntimeError(
                    f"{self.sync_failures} weight broadcasts failed or went "
                    "unacknowledged: runners are sampling with stale params "
                    "(see stderr for per-runner causes)")
        else:
            # Any failure-free sweep resets the consecutive count — refs
            # merely still in flight (sync interval < settle latency) must
            # not let rare recovered blips accumulate into a spurious raise
            # over a multi-day run.
            self.sync_failures = 0

    def foreach_env_runner(self, fn_name: str, *args, **kwargs) -> List[Any]:
        if self._local_runner is not None:
            return [getattr(self._local_runner, fn_name)(*args, **kwargs)]
        return ray_tpu_torch.get([
            getattr(r, fn_name).remote(*args, **kwargs)
            for r in self._remote_runners
        ])

    def get_metrics(self) -> List[Dict[str, Any]]:
        return self.foreach_env_runner("get_metrics")

    def stop(self) -> None:
        # Settle the final broadcast so its refs don't leak store entries;
        # bounded wait — a wedged runner must not block shutdown.
        pending = self._pending_sync
        if pending:
            self._pending_sync = None
            try:
                ray_tpu_torch.wait(pending, num_returns=len(pending),
                                   timeout=2.0)
            except Exception:  # noqa: BLE001 — shutdown goes on regardless
                pass
        if self._local_runner is not None:
            self._local_runner.stop()
        for r in self._remote_runners:
            try:
                ray_tpu_torch.get(r.stop.remote(), timeout=2.0)
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001 — a dead runner is already gone
                pass
