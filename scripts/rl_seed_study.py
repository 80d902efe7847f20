#!/usr/bin/env python3
"""PPO's iterations to a mean return of 450 on CartPole-v1, by seed.

The north-star configuration of ``examples/cartpole_ppo.py`` (train batch
2048, minibatch 128, 8 epochs, lr 3e-4, entropy 0.001, 8 envs with
fragments of 64), run for each seed until the mean return reaches 450 or
for ``--max-iters`` iterations, on the port (``--package ray_tpu_torch``,
on ``--device``, the card unless asked otherwise) or on the JAX reference
(``--package ray_tpu``, always on the CPU). It asks how much the
450-within-150-iterations gate of ``chip_smoke.py``'s ``rl_ppo`` phase
depends on the seed rather than on the code.

``--threads`` sets torch's CPU threads for the run (0 leaves torch's
default, which is what ``chip_smoke.py`` runs at); ``--init-threads`` sets
them while the algorithm is built, i.e. while the orthogonal init draws its
QR on the CPU (default: ``--threads``). The two apart tell whether the
thread count changes a run through the init alone. Each line carries a
hash of the learner's weights as built.

Up to ``--jobs`` seeds run at once, each in its own process. One JSON line
per seed: the iteration that reached 450 (null if none), the best mean
return, and the curve every 10 iterations. ``--summarize`` reads such
lines back, one group per argument (files joined by commas), and prints
each group's passes and median iteration (a miss counts as
``--max-iters``) and, for two groups, the two-sided Mann-Whitney p.

    python3 scripts/rl_seed_study.py --seeds 0 1 2 3 4 5
    python3 scripts/rl_seed_study.py --device cpu --threads 1 --seeds 0 1
    python3 scripts/rl_seed_study.py --summarize one.txt,one_b.txt eight.txt
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _set_threads(n: int, default: int) -> None:
    import torch

    torch.set_num_threads(n if n > 0 else default)


def run_one(package: str, seed: int, device, threads: int,
            init_threads: int, max_iters: int) -> dict:
    if package == "ray_tpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                              "intra_op_parallelism_threads=1")
    sys.path.insert(0, REPO)
    import importlib

    algorithms = importlib.import_module(f"{package}.rl.algorithms")
    config = (algorithms.PPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(train_batch_size=2048, minibatch_size=128,
                        num_epochs=8, lr=3e-4, entropy_coeff=0.001,
                        vf_clip_param=10.0, lambda_=0.95, gamma=0.99)
              .debugging(seed=seed))
    out = {"package": package, "seed": seed}
    if package == "ray_tpu_torch":
        import torch

        default = torch.get_num_threads()
        torch.backends.cuda.matmul.allow_tf32 = False
        _set_threads(init_threads, default)
        algo = config.resources(device=device).build_algo()
        weights = algo.get_weights()
        init = hashlib.sha1()
        for name in sorted(weights):
            init.update(weights[name].detach().cpu().numpy().tobytes())
        _set_threads(threads, default)
        out.update(device=str(next(iter(weights.values())).device),
                   init_threads=init_threads or default,
                   threads=torch.get_num_threads(),
                   init_sha1=init.hexdigest()[:12])
    else:
        algo = config.build_algo()
    curve, reached, t0 = [], None, time.perf_counter()
    for it in range(max_iters):
        curve.append(round(algo.train().get("episode_return_mean", 0.0), 2))
        if curve[-1] >= 450.0:
            reached = it
            break
    algo.stop()
    out.update(reached=reached, best=max(curve), every10=curve[::10],
               seconds=round(time.perf_counter() - t0, 1))
    return out


def summarize(groups, max_iters: int) -> None:
    import numpy as np

    sets = []
    for group in groups:
        rows = [json.loads(line) for path in group.split(",")
                for line in open(path) if line.startswith("{")]
        its = [max_iters if r["reached"] is None else r["reached"]
               for r in rows if "reached" in r]
        sets.append(its)
        print(json.dumps({"group": group, "seeds": len(its),
                          "reached": sum(i < max_iters for i in its),
                          "median": float(np.median(its))}))
    if len(sets) == 2:
        from scipy.stats import mannwhitneyu

        print(json.dumps({"mann_whitney_p": float(mannwhitneyu(
            *sets, alternative="two-sided").pvalue)}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("ray_tpu_torch", "ray_tpu"),
                    default="ray_tpu_torch")
    ap.add_argument("--device", default=None,
                    help="the port's device (default: the card)")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--init-threads", type=int, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--max-iters", type=int, default=150)
    ap.add_argument("--jobs", type=int, default=0,
                    help="seeds run at once (default: all)")
    ap.add_argument("--summarize", nargs="+", metavar="FILES",
                    help="summarize earlier output instead of running")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize, args.max_iters)
        return 0
    init_threads = args.threads if args.init_threads is None else args.init_threads
    if args.one:
        print(json.dumps(run_one(args.package, args.seeds[0], args.device,
                                 args.threads, init_threads, args.max_iters)),
              flush=True)
        return 0
    base = [sys.executable, os.path.abspath(__file__), "--one", "--package",
            args.package, "--threads", str(args.threads), "--init-threads",
            str(init_threads), "--max-iters", str(args.max_iters)]
    if args.device is not None:
        base += ["--device", args.device]
    jobs = args.jobs or len(args.seeds)
    pending, running, rc = list(args.seeds), [], 0
    while pending or running:
        while pending and len(running) < jobs:
            running.append(subprocess.Popen(
                base + ["--seeds", str(pending.pop(0))],
                stdout=subprocess.PIPE, text=True))
        done = [p for p in running if p.poll() is not None]
        if not done:
            time.sleep(0.5)
            continue
        for proc in done:
            running.remove(proc)
            out = proc.stdout.read().strip()
            rc = rc or proc.returncode
            print(out.splitlines()[-1] if out else
                  json.dumps({"failed": proc.args}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
