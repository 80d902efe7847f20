"""The port's Optuna and BOHB adapters (ray_tpu_torch.tune.search.optuna,
.bohb) against the reference's, on the 5 cases of
tests/test_searcher_adapters.py.

Neither optuna nor ConfigSpace is installed here or on the card's machine:
each package's adapter must raise the same ImportError naming its library,
and fakes with the libraries' surface (the reference test's own) drive the
suggest / complete protocol on both packages, whose observations must be
equal. ``HyperBandForBOHB`` needs no library; its decisions on the same
results, and a ``tune.run`` under it, must agree too.
"""

import importlib
import random

import ray_tpu
import ray_tpu_torch
from _torch_train_parity import assert_same, both


def _tune(pkg):
    return importlib.import_module(pkg.__name__ + ".tune")


def _sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _pure_parity(case):
    ref, port = (case(pkg) for pkg in (ray_tpu, ray_tpu_torch))
    assert_same(ref, port, atol=0)
    return port


def _raised(fn):
    try:
        fn()
    except ImportError as e:
        return str(e)
    return None


def import_gates(pkg):
    tune = _tune(pkg)
    return [
        _raised(lambda: _sub(pkg, "tune.search.optuna").OptunaSearch(
            {"x": tune.uniform(0, 1)}, metric="score")),
        _raised(lambda: _sub(pkg, "tune.search.bohb").TuneBOHB(
            {"x": tune.uniform(0, 1)}, metric="score"))]


def test_adapters_raise_clear_importerror_without_libs():
    optuna, bohb = _pure_parity(import_gates)
    assert "optuna" in optuna and "ConfigSpace" in bohb


# ----------------------------------------------------------- fake optuna
class _FakeOptunaTrial:
    def __init__(self, n):
        self.n = n

    def suggest_float(self, name, lo, hi, log=False):
        return lo + (hi - lo) * ((self.n * 37 % 100) / 100)

    def suggest_int(self, name, lo, hi, log=False):
        return lo + (self.n * 13) % (hi - lo + 1)

    def suggest_categorical(self, name, choices):
        return choices[self.n % len(choices)]


class _FakeStudy:
    def __init__(self):
        self.n = 0
        self.tells = []

    def ask(self):
        self.n += 1
        return _FakeOptunaTrial(self.n)

    def tell(self, trial, value=None, state=None):
        self.tells.append([trial.n, value, state])


class _FakeOptuna:
    class samplers:  # noqa: N801 — mirrors the optuna module layout
        @staticmethod
        def TPESampler(seed=None):  # noqa: N802
            return object()

    class trial:  # noqa: N801
        class TrialState:
            FAIL = "FAIL"

    def __init__(self):
        self.created = []

    def create_study(self, direction, sampler):
        s = _FakeStudy()
        self.created.append((direction, s))
        return s


def optuna_contract(pkg):
    tune = _tune(pkg)
    fake = _FakeOptuna()
    search = _sub(pkg, "tune.search.optuna").OptunaSearch(
        {"lr": tune.loguniform(1e-4, 1e-1), "width": tune.randint(8, 64),
         "act": tune.choice(["relu", "gelu"]), "fixed": 7},
        metric="score", mode="min", _optuna_module=fake)
    configs = [search.suggest("t1")]
    search.on_trial_complete("t1", {"score": 0.25})
    configs.append(search.suggest("t2"))
    search.on_trial_complete("t2", error=True)
    configs.append(search.suggest("t3"))
    search.on_trial_complete("t3", {"other": 1.0})
    return {"direction": fake.created[0][0], "configs": configs,
            "tells": fake.created[0][1].tells}


def test_optuna_adapter_contract():
    port = _pure_parity(optuna_contract)
    assert port["direction"] == "minimize"
    cfg = port["configs"][0]
    assert 1e-4 <= cfg["lr"] <= 1e-1 and 8 <= cfg["width"] <= 63
    assert cfg["act"] in ("relu", "gelu") and cfg["fixed"] == 7
    # Errors and a missing metric tell a failed state, not a value.
    assert port["tells"] == [[1, 0.25, None], [2, None, "FAIL"],
                             [3, None, "FAIL"]]


# -------------------------------------------------------- fake ConfigSpace
class _FakeCSSpace:
    def __init__(self, seed=None):
        self._hps = []
        self._rng = random.Random(seed)

    def add(self, hp):
        self._hps.append(hp)

    def sample_configuration(self):
        out = {}
        for kind, name, args in self._hps:
            if kind == "float":
                out[name] = self._rng.uniform(*args)
            elif kind == "int":
                out[name] = self._rng.randint(*args)
            else:
                out[name] = self._rng.choice(args)
        return out


class _FakeConfigSpace:
    @staticmethod
    def ConfigurationSpace(seed=None):  # noqa: N802
        return _FakeCSSpace(seed)

    @staticmethod
    def UniformFloatHyperparameter(name, lower, upper, log=False):  # noqa: N802
        return ("float", name, (lower, upper))

    @staticmethod
    def UniformIntegerHyperparameter(name, lower, upper):  # noqa: N802
        return ("int", name, (lower, upper))

    @staticmethod
    def CategoricalHyperparameter(name, choices):  # noqa: N802
        return ("cat", name, list(choices))


def bohb_model_bias(pkg):
    tune = _tune(pkg)
    search = _sub(pkg, "tune.search.bohb").TuneBOHB(
        {"x": tune.uniform(0.0, 1.0), "n": tune.randint(1, 5),
         "c": tune.choice(["a", "b"]), "tag": "fixed"},
        metric="score", mode="max", seed=0,
        _configspace_module=_FakeConfigSpace())
    first = search.suggest("t0")
    # Completions clustered near x=0.9 win: later suggestions must lean
    # toward the top region (the sample-and-rank model).
    for i in range(8):
        x = 0.9 if i % 2 == 0 else 0.1
        search.on_trial_complete(
            f"w{i}", {"score": 1.0 if x > 0.5 else 0.0,
                      "config": {"x": x, "n": 2, "c": "a", "tag": "fixed"}})
    return {"first": first,
            "picks": [search.suggest(f"p{i}") for i in range(12)]}


def test_bohb_adapter_contract_and_model_bias():
    port = _pure_parity(bohb_model_bias)
    assert 0.0 <= port["first"]["x"] <= 1.0 and port["first"]["tag"] == "fixed"
    assert 1 <= port["first"]["n"] <= 4
    assert sum(p["x"] > 0.5 for p in port["picks"]) >= 8, port["picks"]


def hyperband_decisions(pkg):
    sched = _sub(pkg, "tune.search.bohb").HyperBandForBOHB(
        metric="score", mode="max", max_t=9, reduction_factor=3)

    class T:
        pass

    scores = [(3, 9.0), (3, 8.0), (3, 1.0), (3, 7.0), (3, 0.5), (9, 99.0)]
    # An id()-keyed trial and named ones, as a scheduler sees both.
    anon = [sched.on_trial_result(T(), {"training_iteration": t,
                                        "score": s}) for t, s in scores]
    named = []
    for i, (t, s) in enumerate(scores[:5]):
        trial = T()
        trial.trial_id = f"n{i}"
        named.append(sched.on_trial_result(
            trial, {"training_iteration": t, "score": s - 0.25}))
    return {"rungs": sched._rungs, "anon": anon, "named": named}


def test_hyperband_for_bohb_cuts_bottom_and_caps_budget():
    port = _pure_parity(hyperband_decisions)
    assert port["rungs"] == [3, 9]
    assert port["anon"][:2] == ["CONTINUE", "CONTINUE"]
    assert "STOP" in port["anon"][2:5] and port["anon"][5] == "STOP"


def hyperband_tune_run(pkg):
    tune = _tune(pkg)

    def fn(config):
        for i in range(9):
            tune.report({"score": config["q"] * (i + 1)})

    sched = _sub(pkg, "tune.search.bohb").HyperBandForBOHB(
        metric="score", mode="max", max_t=9, reduction_factor=3)
    grid = tune.run(fn, config={"q": tune.grid_search([0.1, 0.5, 1.0, 2.0])},
                    metric="score", mode="max", scheduler=sched,
                    max_concurrent_trials=4)
    iters = {r.metrics["config"]["q"]: r.metrics["training_iteration"]
             for r in grid}
    # Which poor trial a rung cuts depends on the order results arrive in.
    return {"winner": iters[2.0], "one_cut": min(iters.values()) < 9,
            "errors": grid.num_errors}


def test_hyperband_for_bohb_with_real_tune_run():
    ref, port = both(hyperband_tune_run)
    assert_same(ref, port)
    assert port == {"winner": 9, "one_cut": True, "errors": 0}
