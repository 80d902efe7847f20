"""The port's Tune (ray_tpu_torch.tune) against the reference's
(ray_tpu.tune): the cases of tests/test_tune.py on both packages, then the
port's own.

Each case runs on the reference, then on the port, each in a runtime of its
own (tests/_torch_train_parity.py), and returns what it observed; the two
observations must be equal, integers, strings and configs exactly, floats
within 1e-5. A case that needs no runtime runs on each package in turn.
Then: every decision of ASHA, MedianStoppingRule, PBT and PB2 (seeded) on
the same synthetic result streams, fed straight into each package's
scheduler; the seeded searchers' configs; a ``Tuner`` of GPT-2 tiny trials,
each training through the reference's ``JaxTrainer`` or the port's
``CudaTrainer(use_gpu=False)`` from the same weights (``models.convert``);
``Tuner.restore`` of a run interrupted mid-way; and, on a host with two
faked cards, the card each function trial's thread is granted.
"""

import importlib
import json
import os
import random

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused
from _torch_train_parity import CASE_S, assert_same, both

TOL = 1e-5


def _tune(pkg):
    return importlib.import_module(pkg.__name__ + ".tune")


def _sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _each(case, *args):
    """(reference's observation, port's) of a case that needs no runtime."""
    return [case(pkg, *args) for pkg in (ray_tpu, ray_tpu_torch)]


def _parity(case, *args, init=None, atol=TOL):
    ref, port = both(case, *args, init=init)
    assert_same(ref, port, atol=atol)
    return port


def _pure_parity(case, *args):
    ref, port = _each(case, *args)
    assert_same(ref, port, atol=0)
    return port


# ------------------------------------------------------ tests/test_tune.py

def grid_expansion(pkg):
    tune = _tune(pkg)
    space = {"a": tune.grid_search([1, 2, 3]),
             "b": tune.grid_search(["x", "y"]), "c": 7}
    variants = _sub(pkg, "tune.search_space").expand_grid(space)
    assert len(variants) == 6 and all(v["c"] == 7 for v in variants)
    return variants


def test_grid_expansion():
    _pure_parity(grid_expansion)


def domain_sampling(pkg):
    tune = _tune(pkg)
    space = {"lr": tune.loguniform(1e-5, 1e-1), "bs": tune.choice([16, 32]),
             "n": tune.randint(1, 10)}
    cfg = _sub(pkg, "tune.search_space").resolve(space, random.Random(0))
    assert 1e-5 <= cfg["lr"] <= 1e-1
    assert cfg["bs"] in (16, 32) and 1 <= cfg["n"] <= 10
    return cfg


def test_domain_sampling():
    _pure_parity(domain_sampling)


def basic_variant_counts(pkg):
    search = _sub(pkg, "tune.search")
    gen = search.BasicVariantGenerator({"a": _tune(pkg).grid_search([1, 2])},
                                       num_samples=3)
    configs = []
    while (c := gen.suggest(f"t{len(configs)}")) is not None:
        configs.append(c)
    assert len(configs) == 6
    return configs


def test_basic_variant_counts():
    _pure_parity(basic_variant_counts)


def concurrency_limiter_backpressure(pkg):
    search = _sub(pkg, "tune.search")
    gen = search.ConcurrencyLimiter(
        search.BasicVariantGenerator({"a": 1}, num_samples=5),
        max_concurrent=2)
    out = [gen.suggest("t1"), gen.suggest("t2"), gen.suggest("t3")]
    gen.on_trial_complete("t1", {"score": 1})
    out.append(gen.suggest("t3"))
    assert out[2] == "PENDING" and isinstance(out[3], dict)
    return out


def test_concurrency_limiter_backpressure():
    _pure_parity(concurrency_limiter_backpressure)


def tuner_function_api(pkg):
    tune = _tune(pkg)

    def objective(config):
        score = -((config["x"] - 3.0) ** 2)
        for i in range(3):
            tune.report({"score": score + i * 0.01})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
    return {"n": len(grid), "errors": grid.num_errors,
            "best_x": grid.get_best_result().metrics["config"]["x"],
            "scores": sorted((r.metrics["config"]["x"],
                              [m["score"] for m in r.metrics_history])
                             for r in grid)}


def test_tuner_function_api():
    port = _parity(tuner_function_api)
    assert port["best_x"] == 3.0 and port["errors"] == 0


def tuner_kwargs_report_and_stop(pkg):
    tune = _tune(pkg)

    def fn(config):
        for i in range(100):
            tune.report(value=i)

    grid = tune.run(fn, config={}, metric="value", mode="max",
                    stop={"value": 5}, num_samples=1)
    return grid.get_best_result().metrics["value"]


def test_tuner_kwargs_report_and_stop():
    assert _parity(tuner_kwargs_report_and_stop) == 5


def tuner_class_api(pkg):
    tune = _tune(pkg)

    class Quad(tune.Trainable):
        def setup(self, config):
            self.x = config["x"]
            self.state = 0

        def step(self):
            self.state += 1
            return {"score": -(self.x - 2.0) ** 2, "state": self.state}

        def save_checkpoint(self, d):
            return {"state": self.state}

        def load_checkpoint(self, data, d):
            self.state = data["state"]

    grid = tune.run(Quad, config={"x": tune.grid_search([0.0, 2.0])},
                    metric="score", mode="max",
                    stop={"training_iteration": 4})
    best = grid.get_best_result()
    return {"best_x": best.metrics["config"]["x"],
            "iters": best.metrics["training_iteration"],
            "states": sorted(r.metrics["state"] for r in grid)}


def test_tuner_class_api():
    port = _parity(tuner_class_api)
    assert port["best_x"] == 2.0 and port["iters"] == 4


def trial_errors_surface(pkg):
    tune = _tune(pkg)

    def bad(config):
        raise ValueError("boom")

    grid = tune.run(bad, config={}, metric="m", mode="max", num_samples=2)
    return {"errors": grid.num_errors,
            "boom": all("boom" in repr(e) for e in grid.errors)}


def test_trial_errors_surface():
    assert _parity(trial_errors_surface) == {"errors": 2, "boom": True}


def asha_stops_bad_trials(pkg):
    tune = _tune(pkg)

    def fn(config):
        for i in range(20):
            tune.report({"score": config["quality"] * (i + 1)})

    sched = _sub(pkg, "tune.schedulers").ASHAScheduler(
        time_attr="training_iteration", max_t=20, grace_period=2,
        reduction_factor=2)
    grid = tune.run(fn, config={"quality": tune.grid_search(
        [0.1, 0.2, 1.0, 2.0])}, metric="score", mode="max", scheduler=sched,
        max_concurrent_trials=4)
    iters = {r.metrics["config"]["quality"]: r.metrics["training_iteration"]
             for r in grid}
    # Which poor trial a rung cuts first depends on the order results
    # arrive in; that the best runs to the end and one is cut does not.
    return {"best_iters": iters[2.0], "one_cut": min(iters.values()) < 20}


def test_asha_stops_bad_trials():
    assert _parity(asha_stops_bad_trials) == {"best_iters": 20,
                                              "one_cut": True}


def _lr_fn(tune):
    """test_tune.py's PBT toy: a score that grows by ``lr`` a report and
    is carried in a checkpoint directory."""
    def fn(config):
        import tempfile

        lr = config["lr"]
        score = 0.0
        ckpt = tune.get_checkpoint()
        if ckpt:
            with open(os.path.join(ckpt.path, "s.txt")) as f:
                score = float(f.read())
        for _ in range(12):
            score += lr
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "s.txt"), "w") as f:
                f.write(str(score))
            tune.report({"score": score},
                        checkpoint=tune.Checkpoint.from_directory(d))

    return fn


def pbt_exploits(pkg):
    tune = _tune(pkg)
    sched = _sub(pkg, "tune.schedulers").PopulationBasedTraining(
        time_attr="training_iteration", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 10.0)}, seed=0)
    grid = tune.run(_lr_fn(tune), config={"lr": tune.grid_search(
        [0.1, 0.2, 5.0, 8.0])}, metric="score", mode="max", scheduler=sched,
        max_concurrent_trials=4)
    return {"errors": grid.num_errors, "terminated": grid.num_terminated}


def test_pbt_exploits():
    assert _parity(pbt_exploits) == {"errors": 0, "terminated": 4}


def experiment_state_written(pkg, tmp_path):
    tune = _tune(pkg)
    root = tmp_path / pkg.__name__

    def objective(config):
        tune.report({"score": config["x"]})

    tune.Tuner(objective, param_space={"x": 1.0},
               tune_config=tune.TuneConfig(metric="score", mode="max"),
               run_config=tune.RunConfig(name="exp",
                                         storage_path=str(root))).fit()
    state = json.loads((root / "exp" / "experiment_state.json").read_text())
    return [{k: t[k] for k in ("status", "config", "checkpoint", "error")}
            | {"score": t["last_result"]["score"]} for t in state["trials"]]


def test_experiment_state_written(tmp_path):
    _parity(experiment_state_written, tmp_path)


def pb2_explores_within_bounds(pkg):
    tune = _tune(pkg)
    sched = _sub(pkg, "tune.schedulers").PB2(
        time_attr="training_iteration", perturbation_interval=3,
        hyperparam_bounds={"lr": [0.1, 10.0]}, seed=0)
    grid = tune.run(_lr_fn(tune), config={"lr": tune.grid_search(
        [0.1, 0.5, 5.0, 8.0])}, metric="score", mode="max", scheduler=sched,
        max_concurrent_trials=4)
    return {"errors": grid.num_errors, "terminated": grid.num_terminated,
            "in_bounds": all(0.1 <= r.metrics["config"]["lr"] <= 10.0
                             for r in grid)}


def test_pb2_explores_within_bounds():
    assert _parity(pb2_explores_within_bounds) == {
        "errors": 0, "terminated": 4, "in_bounds": True}


def tuner_restore_resumes_unfinished(pkg, tmp_path):
    tune = _tune(pkg)
    root = tmp_path / pkg.__name__
    marker = root / "second_attempt"
    root.mkdir()

    def flaky(config):
        if config["x"] == 2 and not marker.exists():
            marker.write_text("tried")
            raise RuntimeError("simulated crash")
        tune.report({"score": config["x"] * 10.0, "done": True})

    grid = tune.Tuner(
        flaky, param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="restorable",
                                  storage_path=str(root))).fit()
    restored = tune.Tuner.restore(str(root / "restorable"), flaky)
    restored.tune_config = tune.TuneConfig(metric="score", mode="max")
    grid2 = restored.fit()
    return {"errors": grid.num_errors, "errors_after": grid2.num_errors,
            "terminated": grid2.num_terminated,
            "scores": sorted(r.metrics["score"] for r in grid2)}


def test_tuner_restore_resumes_unfinished(tmp_path):
    assert _parity(tuner_restore_resumes_unfinished, tmp_path) == {
        "errors": 1, "errors_after": 0, "terminated": 3,
        "scores": [10.0, 20.0, 30.0]}


# ------------------------------------------- the schedulers' decisions

class _T:
    """What a scheduler reads of a trial."""

    def __init__(self, trial_id, config):
        self.trial_id = trial_id
        self.config = config
        self.pbt_exploit = None


def _scheduler(pkg, kind, mode):
    s = _sub(pkg, "tune.schedulers")
    metric = "score" if mode == "max" else "loss"
    if kind == "asha":
        return s.ASHAScheduler(metric=metric, mode=mode, max_t=12,
                               grace_period=1, reduction_factor=2,
                               brackets=3)
    if kind == "median":
        return s.MedianStoppingRule(metric=metric, mode=mode, grace_period=2,
                                    min_samples_required=3)
    if kind == "pbt":
        return s.PopulationBasedTraining(
            metric=metric, mode=mode, perturbation_interval=2,
            hyperparam_mutations={
                "lr": _tune(pkg).loguniform(1e-4, 1e-1),
                "bs": [8, 16, 32], "wd": lambda: 0.5}, seed=3)
    return s.PB2(metric=metric, mode=mode, perturbation_interval=2,
                 hyperparam_bounds={"lr": [1e-4, 1e-1], "bs": [8.0, 32.0]},
                 seed=3)


def scheduler_decisions(pkg, kind, mode, seed=0, n_trials=8, max_iters=12):
    """Results of n_trials trials, one at a time in a seeded random order,
    into one scheduler; every decision, and every exploit's donor and new
    config, as the controller would act on it (a stop ends the trial, an
    exploit takes the new config)."""
    sched = _scheduler(pkg, kind, mode)
    cls = _sub(pkg, "tune.schedulers").TrialScheduler
    rng = np.random.default_rng(seed)
    trials = [_T(f"t{i}", {"lr": float(10 ** rng.uniform(-4, -1)),
                           "bs": int(rng.choice([8, 16, 32])), "wd": 0.1})
              for i in range(n_trials)]
    for t in trials:
        sched.on_trial_add(t)
    iters = {t.trial_id: 0 for t in trials}
    live, log = list(trials), []
    metric = "score" if mode == "max" else "loss"
    while live:
        t = live[int(rng.integers(len(live)))]
        iters[t.trial_id] += 1
        it = iters[t.trial_id]
        value = float(np.log10(t.config["lr"]) * it / t.config["bs"]
                      + rng.normal(0, 0.05))
        result = {"training_iteration": it,
                  metric: value if mode == "max" else -value,
                  "config": dict(t.config)}
        decision = sched.on_trial_result(t, result)
        entry = [t.trial_id, it, decision]
        if decision == cls.PAUSE and t.pbt_exploit is not None:
            payload, t.pbt_exploit = t.pbt_exploit, None
            entry += [payload["donor"].trial_id, payload["new_config"]]
            t.config = payload["new_config"]
        elif decision == cls.STOP or it >= max_iters:
            sched.on_trial_complete(t, result)
            live.remove(t)
        log.append(entry)
    return log


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("kind", ["asha", "median", "pbt", "pb2"])
def test_scheduler_decisions_match(kind, mode):
    log = _pure_parity(scheduler_decisions, kind, mode)
    decisions = {entry[2] for entry in log}
    if kind in ("asha", "median"):
        assert "STOP" in decisions, log
    else:
        assert any(len(entry) == 5 for entry in log), log


# ------------------------------------------------- the seeded searchers

def _space(tune):
    return {"lr": tune.loguniform(1e-5, 1e-1), "bs": tune.choice([8, 16]),
            "n": tune.randint(1, 10), "q": tune.quniform(0.0, 1.0, 0.25),
            "z": tune.randn(0.0, 2.0), "k": tune.lograndint(1, 64),
            "m": tune.qrandint(0, 100, 10), "u": tune.uniform(-1.0, 1.0),
            "opt": tune.grid_search(["adam", "sgd"]),
            "nested": {"drop": tune.uniform(0.0, 0.5), "fixed": 3}}


def searcher_configs(pkg, kind):
    tune = _tune(pkg)
    search = _sub(pkg, "tune.search")
    if kind == "basic":
        gen = search.BasicVariantGenerator(
            _space(tune), num_samples=3, seed=7,
            points_to_evaluate=[{"lr": 0.01, "bs": 8, "n": 2}])
    elif kind == "random":
        gen = search.RandomSearch(_space(tune), num_samples=6, seed=7)
    else:
        space = {k: v for k, v in _space(tune).items() if k != "nested"}
        gen = search.HyperOptStyleSearcher(space, metric="score", mode="max",
                                           num_samples=12, seed=7)
    out = []
    while (cfg := gen.suggest(f"t{len(out)}")) is not None:
        out.append(cfg)
        # Completions let the adaptive searcher exploit its best configs.
        gen.on_trial_complete(f"t{len(out)}", {
            "score": -abs(np.log10(cfg["lr"]) + 3), "config": cfg})
    return out


@pytest.mark.parametrize("kind", ["basic", "random", "hyperopt"])
def test_seeded_searchers_suggest_the_same_configs(kind):
    configs = _pure_parity(searcher_configs, kind)
    assert len(configs) == {"basic": 7, "random": 6, "hyperopt": 12}[kind]


# ------------------------------------------------ GPT-2 tiny trials

B, STEPS = 4, 3


@pytest.fixture(scope="module")
def gpt2_init():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.examples import train_gpt2

    cfg = dataclasses.replace(
        jgpt2.GPTConfig.tiny(), dtype=jnp.float32, logits_dtype=jnp.float32,
        loss_impl="fused", remat_policy="attn_outside", **train_gpt2.TINY)
    params = jax.tree.map(np.asarray, jgpt2.init_params(cfg,
                                                        jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(
        0, train_gpt2.TINY["vocab_size"],
        (B * STEPS, train_gpt2.TINY["seq_len"] + 1), dtype=np.int64)
    return cfg, params, tokens


def _jax_trial(cfg, init, tokens):
    """A trial that trains GPT-2 tiny through the reference's JaxTrainer at
    its config's lr and reports the fit's losses, one report a step."""
    def trial(config):
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu import train, tune
        from ray_tpu.models import gpt2 as jgpt2
        from ray_tpu.train import JaxTrainer, ScalingConfig

        lr, S = config["lr"], cfg.seq_len

        def loop():
            params = jax.tree.map(jnp.asarray, init)
            opt = jgpt2.make_optimizer(lr)
            state = opt.init(params)
            vg = jax.jit(jax.value_and_grad(
                lambda p, a, b: jgpt2.loss_fn(p, a, b, cfg)))
            for i in range(STEPS):
                tok = tokens[i * B:(i + 1) * B]
                loss, g = vg(params, tok[:, :S], tok[:, 1:])
                updates, state = opt.update(g, state, params)
                params = optax.apply_updates(params, updates)
                train.report({"step": i + 1, "loss": float(loss)})

        res = JaxTrainer(loop, scaling_config=ScalingConfig(
            num_workers=1)).fit()
        if res.error is not None:
            raise res.error
        for m in res.metrics_history:
            tune.report({"step": m["step"], "loss": m["loss"]})

    return trial


def _port_trial(init, tokens):
    def trial(config):
        from ray_tpu_torch import tune
        from ray_tpu_torch.examples import train_gpt2
        from ray_tpu_torch.train import CudaTrainer, ScalingConfig

        res = CudaTrainer(
            train_gpt2.train_loop_per_worker,
            train_loop_config=dict(steps=STEPS, batch_size=B, tiny=True,
                                   device="cpu", init_params=init,
                                   tokens=tokens, lr=config["lr"]),
            scaling_config=ScalingConfig(num_workers=1,
                                         use_gpu=False)).fit()
        if res.error is not None:
            raise res.error
        for m in res.metrics_history:
            tune.report({"step": m["step"], "loss": m["loss"]})

    return trial


def gpt2_trials(pkg, trial, storage):
    tune = _tune(pkg)
    grid = tune.Tuner(
        trial, param_space={"lr": tune.grid_search([1e-3, 1e-2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1),
        run_config=tune.RunConfig(name="gpt2",
                                  storage_path=str(storage / pkg.__name__))
    ).fit()
    assert grid.num_errors == 0, grid.errors
    return {"losses": {str(r.metrics["config"]["lr"]):
                       [m["loss"] for m in r.metrics_history
                        if "loss" in m] for r in grid},
            "steps": sorted([m["step"] for m in r.metrics_history
                             if "step" in m] for r in grid),
            "best_lr": grid.get_best_result().metrics["config"]["lr"]}


def test_gpt2_tiny_trials_match_jax_trainer_trials(gpt2_init, tmp_path):
    cfg, init, tokens = gpt2_init
    with gc_paused():
        fresh_init(ray_tpu, num_cpus=4)
        try:
            ref = bounded(lambda: gpt2_trials(
                ray_tpu, _jax_trial(cfg, init, tokens), tmp_path), CASE_S)
        finally:
            ray_tpu.shutdown()
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        port = bounded(lambda: gpt2_trials(
            ray_tpu_torch, _port_trial(init, tokens), tmp_path), CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert port["steps"] == [[1, 2, 3]] * 2
    assert_same(ref, port, atol=TOL)
    # The two learning rates trained differently.
    assert port["losses"]["0.001"][-1] != port["losses"]["0.01"][-1]


# ----------------------------------------- a run interrupted mid-way

class _Interrupt(Exception):
    pass


def interrupted_run_restores(pkg, tmp_path):
    """The experiment is cut at its first result (a callback raises out of
    ``fit``, as a crash of the process running it would end it); the
    periodic snapshot it left holds both trials unfinished, and
    ``Tuner.restore`` runs them to the end."""
    tune = _tune(pkg)
    root = tmp_path / pkg.__name__
    state_file = root / "cut" / "experiment_state.json"

    def fn(config):
        import time

        # Report only once the snapshot exists: the cut then leaves one.
        while not state_file.exists():
            time.sleep(0.01)
        for i in range(3):
            tune.report({"score": config["x"] * (i + 1)})

    class Cut:
        def on_trial_result(self, trial, result):
            raise _Interrupt("cut")

    space = {"x": tune.grid_search([1.0, 2.0])}
    tuner = tune.Tuner(fn, param_space=space,
                       tune_config=tune.TuneConfig(metric="score", mode="max",
                                                   max_concurrent_trials=2),
                       run_config=tune.RunConfig(name="cut",
                                                 storage_path=str(root),
                                                 callbacks=[Cut()]))
    try:
        tuner.fit()
        cut = None
    except _Interrupt as e:
        cut = str(e)
    before = json.loads(state_file.read_text())
    restored = tune.Tuner.restore(
        str(root / "cut"), fn,
        tune_config=tune.TuneConfig(metric="score", mode="max"))
    grid = restored.fit()
    after = json.loads(state_file.read_text())
    return {"cut": cut,
            "before": sorted((t["config"]["x"], t["status"])
                             for t in before["trials"]),
            "after": sorted((t["config"]["x"], t["status"],
                             t["last_result"].get("score"))
                            for t in after["trials"]),
            "errors": grid.num_errors, "terminated": grid.num_terminated,
            "histories": sorted([m["score"] for m in r.metrics_history]
                                for r in grid),
            "best": grid.get_best_result().metrics["score"]}


def test_tuner_restore_of_an_interrupted_run(tmp_path):
    port = _parity(interrupted_run_restores, tmp_path)
    assert port["cut"] == "cut"
    assert port["before"] == [[1.0, "RUNNING"], [2.0, "RUNNING"]]
    assert port["terminated"] == 2 and port["best"] == 6.0
    assert port["histories"] == [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0]]


# ----------------------------------------------------- the trial's card

def test_function_trials_run_on_their_leases_card(monkeypatch):
    """Two {"GPU": 1} function trials on a host with two cards (torch's
    count faked): each trial's thread sees its own lease, and
    ``granted_cuda_device()`` there names that card, not the thread's
    current device."""
    from ray_tpu_torch import tune
    from ray_tpu_torch._private import device

    monkeypatch.setattr(device, "gpu_count", lambda: 2)
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        def fn(config):
            import threading

            tune.report({"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                         "device": str(device.granted_cuda_device()),
                         "thread": threading.current_thread().name})

        grid = bounded(lambda: tune.Tuner(
            fn, param_space={"i": tune.grid_search([0, 1])},
            tune_config=tune.TuneConfig(trial_resources={"GPU": 1})).fit(),
            CASE_S)
    finally:
        ray_tpu_torch.shutdown()
    assert grid.num_errors == 0, grid.errors
    # A trial's last result may be the one that says it is done.
    reports = [m for r in grid for m in r.metrics_history if "device" in m]
    seen = sorted((m["gpu_ids"], m["device"]) for m in reports)
    assert seen == [([0], "cuda:0"), ([1], "cuda:1")]
    assert all(m["thread"].startswith("trial-") for m in reports)
