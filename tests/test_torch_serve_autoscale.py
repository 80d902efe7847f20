"""The port's serve autoscaling policy and reconciler
(ray_tpu_torch.serve.autoscaling, .deployment_state) against the reference
(ray_tpu.serve), on the cases of tests/test_serve_autoscale.py that do not
need the SLO watchdog, the target-qps policy or the LLM prefix directory.

The policy runs under a deterministic clock: each case feeds the same
``PolicyInputs`` sequence to both packages' ``DeploymentAutoscaler`` and
the decisions (target, reason, changed) must be equal. The reconciler
cases drive ``DeploymentState`` with fake replicas, no runtime.
"""

import importlib

import pytest

import ray_tpu.serve  # noqa: F401 — registers the reference's modules
import ray_tpu_torch.serve  # noqa: F401

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.serve.{name}")


# (config kwargs, [(now, running, target, extra inputs), ...])
SCENARIOS = {
    "upscale_waits_hysteresis_delay": (
        dict(upscale_delay_s=3.0, upscale_cooldown_s=0.0),
        [(100.0, 1, 1, dict(total_inflight=8)),
         (102.9, 1, 1, dict(total_inflight=8)),
         (103.0, 1, 1, dict(total_inflight=8))]),
    "upscale_hysteresis_resets_when_load_drops": (
        dict(upscale_delay_s=3.0),
        [(100.0, 1, 1, dict(total_inflight=8)),
         (101.0, 1, 1, dict(total_inflight=1)),
         (103.5, 1, 1, dict(total_inflight=8)),
         (106.5, 1, 1, dict(total_inflight=8))]),
    "upscale_cooldown_spaces_consecutive_ups": (
        dict(upscale_delay_s=0.0, upscale_cooldown_s=5.0),
        [(100.0, 1, 1, dict(total_inflight=4)),
         (101.0, 2, 2, dict(total_inflight=12)),
         (105.0, 2, 2, dict(total_inflight=12))]),
    "downscale_needs_delay_and_cooldown_and_steps_by_one": (
        dict(upscale_delay_s=0.0, upscale_cooldown_s=0.0,
             downscale_delay_s=10.0, downscale_cooldown_s=20.0),
        [(100.0, 4, 4, dict(total_inflight=1)),
         (109.9, 4, 4, dict(total_inflight=1)),
         (110.0, 4, 4, dict(total_inflight=1)),
         (121.0, 3, 3, dict(total_inflight=1)),
         (129.0, 3, 3, dict(total_inflight=1)),
         (135.0, 3, 3, dict(total_inflight=1))]),
    "crash_loop_interlock_freezes_target": (
        dict(upscale_delay_s=0.0, upscale_cooldown_s=0.0),
        [(100.0, 1, 1, dict(total_inflight=20, in_backoff=True)),
         (101.0, 1, 1, dict(total_inflight=0)),
         (102.0, 1, 1, dict(total_inflight=20))]),
    "scale_to_zero_then_wake_round_trip": (
        dict(min_replicas=0, max_replicas=4, scale_to_zero_idle_s=60.0,
             downscale_delay_s=0.0, downscale_cooldown_s=0.0,
             upscale_delay_s=5.0, upscale_cooldown_s=5.0),
        [(100.0, 1, 1, dict(total_inflight=1)), (110.0, 1, 1, {}),
         (169.9, 1, 1, {}), (170.0, 1, 1, {}), (200.0, 0, 0, {}),
         (200.1, 0, 0, dict(queued_requests=1))]),
    "floor_is_min_replicas_when_positive": (
        dict(min_replicas=2, downscale_delay_s=0.0, downscale_cooldown_s=0.0),
        [(100.0, 3, 3, {}), (200.0, 2, 2, {})]),
    "at_floor_holds_one_replica_when_min_zero": (
        dict(min_replicas=0, max_replicas=4, downscale_delay_s=0.0,
             downscale_cooldown_s=0.0, scale_to_zero_idle_s=300.0),
        [(100.0, 1, 1, {})]),
}

#: The reference tests' assertions on the decisions: (changed, target,
#: reason) per step, None where they assert nothing about the step.
EXPECTED = {
    "upscale_waits_hysteresis_delay": [
        (False, 1, "pending_up:queue_depth"), (False, 1, None),
        (True, 4, "queue_depth")],
    "upscale_hysteresis_resets_when_load_drops": [
        None, None, (False, 1, None), (True, 4, None)],
    "upscale_cooldown_spaces_consecutive_ups": [
        (True, 2, None), (False, 2, None), (True, 6, None)],
    "downscale_needs_delay_and_cooldown_and_steps_by_one": [
        (False, 4, "pending_down"), (False, 4, None), (True, 3, "scale_down"),
        (False, 3, "pending_down"), (False, 3, None), (True, 2, None)],
    "crash_loop_interlock_freezes_target": [
        (False, 1, "crash_loop_backoff"), (False, 1, "steady"),
        (True, 8, None)],
    "scale_to_zero_then_wake_round_trip": [
        (False, 1, None), (False, 1, None), (False, 1, None),
        (True, 0, "scale_to_zero"), (False, 0, None),
        (True, 1, "wake_from_zero")],
    "floor_is_min_replicas_when_positive": [
        (True, 2, "scale_down"), (False, 2, "steady")],
    "at_floor_holds_one_replica_when_min_zero": [(False, 1, "at_floor")],
}


def _decisions(pkg, name):
    autoscaling = _mod(pkg, "autoscaling")
    config = _mod(pkg, "config")
    cfg_kw, steps = SCENARIOS[name]
    cfg = config.AutoscalingConfig(**{"min_replicas": 1, "max_replicas": 8,
                                      "target_ongoing_requests": 2.0,
                                      **cfg_kw})
    scaler = autoscaling.DeploymentAutoscaler("a#D", cfg)
    out = []
    for now, running, target, extra in steps:
        d = scaler.decide(autoscaling.PolicyInputs(
            now=now, num_running=running, target_num=target, **extra))
        out.append((d.changed, d.target, d.reason))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_match_reference(name):
    ref = _decisions("ray_tpu", name)
    port = _decisions("ray_tpu_torch", name)
    for got, want in zip(ref, EXPECTED[name]):
        if want is not None:
            assert got[:2] == want[:2]
            assert want[2] is None or got[2] == want[2]
    assert port == ref


@pytest.mark.parametrize("kwargs", [
    dict(min_replicas=-1), dict(min_replicas=4, max_replicas=2),
    dict(min_replicas=0, max_replicas=0),
    dict(min_replicas=1, max_replicas=4, initial_replicas=5),
    dict(target_ongoing_requests=0), dict(warm_pool_size=-1),
    dict(upscale_cooldown_s=-1.0), dict(scale_to_zero_idle_s=-1.0)])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_config_rejects_bad_shapes(pkg, kwargs):
    with pytest.raises(ValueError):
        _mod(pkg, "config").AutoscalingConfig(**kwargs)


def _state(pkg, asc, n_running=0):
    """A DeploymentState over fake replicas: no actors, health probes pass,
    draining completes at once. An infinite backoff keeps reconcile from
    starting real replicas (promotion is not gated by it)."""
    ds_mod = _mod(pkg, "deployment_state")
    config = _mod(pkg, "config")

    def f():
        return None

    info = ds_mod.DeploymentInfo(
        name="D", app_name="a", deployment_def=f,
        config=config.DeploymentConfig(autoscaling_config=asc))
    ds = ds_mod.DeploymentState(info)
    ds.backoff_until = float("inf")
    v = info.version()
    ds.replicas = [_FakeReplica(f"D#r{i}", v) for i in range(n_running)]
    return ds


class _FakeReplica:
    def __init__(self, replica_id, version, state="RUNNING", warm=False):
        self.replica_id = replica_id
        self.version = version
        self.state = state
        self.warm = warm
        self.unhealthy_reason = None
        self.multiplexed_model_ids = []
        self.actor = None
        self.drained = False

    def probe_health(self, now, config):
        return None

    def check_ready(self):
        return None

    def begin_drain(self, reason=None):
        self.state = "DRAINING"
        self.drained = True

    def check_stopped(self):
        return True

    def hard_kill(self):
        pass


def _seeding(pkg):
    config = _mod(pkg, "config")
    out = []
    for kw in (dict(min_replicas=0, max_replicas=4),
               dict(min_replicas=0, max_replicas=4, initial_replicas=0),
               dict(min_replicas=2, max_replicas=4)):
        out.append(_state(pkg, config.AutoscalingConfig(**kw)).target_num)
    return out


def _starting_victim_first(pkg):
    config = _mod(pkg, "config")
    ds = _state(pkg, config.AutoscalingConfig(min_replicas=1, max_replicas=4),
                n_running=3)
    ds.replicas[2].state = "STARTING"  # costs no capacity: drained first
    ds.target_num = 2
    ds.reconcile()
    return [r.replica_id for r in ds.replicas if r.drained]


def _warm_promotion(pkg):
    config = _mod(pkg, "config")
    ds = _state(pkg, config.AutoscalingConfig(min_replicas=0, max_replicas=4,
                                              warm_pool_size=1), n_running=1)
    ds.replicas.append(_FakeReplica("D#warm", ds.info.version(), state="WARM",
                                    warm=True))
    ds.target_num = 2
    changed = ds.reconcile()
    warm = ds.replicas[-1]
    return [changed, warm.state, warm.warm, ds.num_warm_promotions,
            ds.num_cold_starts, len(ds.replicas)]


def _outdated_warm_drains(pkg):
    config = _mod(pkg, "config")
    ds = _state(pkg, config.AutoscalingConfig(min_replicas=1, max_replicas=4,
                                              warm_pool_size=1), n_running=1)
    stale = _FakeReplica("D#old", "stale-version", state="WARM", warm=True)
    ds.replicas.append(stale)
    ds.reconcile()
    return [stale.drained, stale.warm]


def _num_replicas_auto(pkg):
    serve = importlib.import_module(f"{pkg}.serve")
    config = _mod(pkg, "config")

    @serve.deployment(num_replicas="auto")
    class Auto:
        def __call__(self):
            return 1

    @serve.deployment
    class Plain:
        def __call__(self):
            return 1

    asc = Auto.config.autoscaling_config
    custom = config.AutoscalingConfig(min_replicas=2, max_replicas=3)
    return [(asc.min_replicas, asc.max_replicas),
            Plain.options(num_replicas="auto").config.autoscaling_config
            is not None,
            Plain.options(num_replicas="auto", autoscaling_config=custom)
            .config.autoscaling_config is custom]


RECONCILER_CASES = [
    (_seeding, [1, 0, 2]),
    (_starting_victim_first, ["D#r2"]),
    (_warm_promotion, [True, "RUNNING", False, 1, 0, 2]),
    (_outdated_warm_drains, [True, False]),
    (_num_replicas_auto, [(1, 8), True, True]),
]


@pytest.mark.parametrize("case,expected", RECONCILER_CASES,
                         ids=[c.__name__.lstrip("_") for c, _ in RECONCILER_CASES])
def test_reconciler_matches_reference(case, expected):
    ref = case("ray_tpu")
    assert ref == expected
    assert case("ray_tpu_torch") == ref
