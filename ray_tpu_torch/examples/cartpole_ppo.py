"""PPO on CartPole-v1 to a 450 mean return — the north-star RL workload.

The port of ``examples/cartpole_ppo.py`` (ref: rllib/tuned_examples/ppo/
cartpole_ppo.py — default_reward=450.0 pass criterion run in the
reference's CI as a learning test): the same configuration, flags and
output lines, on the port's own CartPole-v1 (``rl/env/cartpole.py``), with
the learner and the runner's forward on ``--device`` (the card unless
``--device cpu``).

Run: python -m ray_tpu_torch.examples.cartpole_ppo [--stop-reward 450]
     [--as-test] [--device cpu]
"""

from __future__ import annotations

import argparse
import time


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stop-reward", type=float, default=450.0)
    parser.add_argument("--stop-iters", type=int, default=200)
    parser.add_argument("--num-env-runners", type=int, default=0)
    parser.add_argument("--as-test", action="store_true",
                        help="exit non-zero if the reward target is not hit")
    parser.add_argument("--device", default=None,
                        help="the learner's and runners' device (default: "
                             "the card; 'cpu' to run without one)")
    args = parser.parse_args()

    import ray_tpu_torch
    from ray_tpu_torch.rl.algorithms import PPOConfig

    ray_tpu_torch.init(ignore_reinit_error=True)
    config = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=args.num_env_runners,
                     num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .training(train_batch_size=2048, minibatch_size=128, num_epochs=8,
                  lr=3e-4, entropy_coeff=0.001, vf_clip_param=10.0,
                  lambda_=0.95, gamma=0.99)
        .resources(device=args.device)
        .debugging(seed=0)
    )
    algo = config.build_algo()
    best = 0.0
    t0 = time.time()
    for i in range(args.stop_iters):
        result = algo.train()
        ret = result.get("episode_return_mean", float("nan"))
        best = max(best, ret if ret == ret else 0.0)
        print(f"iter={i:3d} steps={result['num_env_steps_sampled_lifetime']:7d} "
              f"return_mean={ret:7.2f} best={best:7.2f} "
              f"elapsed={time.time() - t0:6.1f}s")
        if best >= args.stop_reward:
            print(f"Target {args.stop_reward} reached at iter {i}.")
            break
    algo.stop()
    ray_tpu_torch.shutdown()
    if args.as_test and best < args.stop_reward:
        print(f"FAILED: best={best} < {args.stop_reward}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
