"""The port's serve autoscaling policies and reconciler
(ray_tpu_torch.serve.autoscaling, .deployment_state, the controller's
autoscale tick) against the reference (ray_tpu.serve), on the cases of
tests/test_serve_autoscale.py that do not need the LLM prefix directory.

The policies run under a deterministic clock: each case feeds the same
``PolicyInputs`` sequence to both packages' ``DeploymentAutoscaler`` and
the decisions (target, reason, changed) must be equal, exactly. The
reconciler cases drive ``DeploymentState`` with fake replicas, no runtime.
The live cases run a serve instance of each package in turn, one of them
under tests/test_serve_chaos.py's ``serve_autoscale`` fault point; the last
drives the port's controller end to end with GPT-2 in the tiny config on
the CPU: one deployment scales 1 -> 2 on its request rate
(``"target_qps"``), another on the SLO burn of real request errors
(``"slo_burn"``).
"""

import importlib
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.serve  # noqa: F401 — registers the reference's modules
import ray_tpu_torch
import ray_tpu_torch.serve  # noqa: F401

from _torch_runtimes import fresh_init, gc_paused

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
    "burn_overrides_qps_and_bypasses_upscale_delay": (
        dict(upscale_delay_s=30.0, upscale_cooldown_s=0.0,
             target_qps_per_replica=10.0, burn_upscale_factor=2.0),
        [(100.0, 2, 2, dict(request_rate=22.0)),
         (100.5, 2, 2, dict(request_rate=22.0, burn_alerting=True,
                            burn_quiet=False))]),
    "occupancy_saturation_forces_extra_replica": (
        dict(upscale_delay_s=0.0, target_qps_per_replica=100.0),
        [(100.0, 3, 3, dict(request_rate=5.0, batch_occupancy=0.97))]),
    "downscale_held_until_all_burn_windows_quiet": (
        dict(downscale_delay_s=0.0, downscale_cooldown_s=0.0),
        [(100.0, 4, 4, dict(total_inflight=1, burn_alerting=False,
                            burn_quiet=False)),
         (101.0, 4, 4, dict(total_inflight=1, burn_quiet=True))]),
    "scale_to_zero_blocked_while_burn_not_quiet": (
        dict(min_replicas=0, max_replicas=4, scale_to_zero_idle_s=1.0,
             downscale_delay_s=0.0, downscale_cooldown_s=0.0),
        [(100.0, 1, 1, {}),
         (105.0, 1, 1, dict(burn_quiet=False, burn_alerting=False)),
         (106.0, 1, 1, dict(burn_quiet=True))]),
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
    "burn_overrides_qps_and_bypasses_upscale_delay": [
        (False, 2, "pending_up:target_qps"), (True, 4, "slo_burn")],
    "occupancy_saturation_forces_extra_replica": [(True, 4, "target_qps")],
    "downscale_held_until_all_burn_windows_quiet": [
        (False, 4, "hold_burn_not_quiet"), (True, 3, None)],
    "scale_to_zero_blocked_while_burn_not_quiet": [
        None, (False, 1, None), (True, 0, None)],
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
    dict(upscale_cooldown_s=-1.0), dict(scale_to_zero_idle_s=-1.0),
    dict(target_qps_per_replica=-1.0), dict(target_qps_per_replica=0.0),
    dict(qps_window_s=-1.0), dict(burn_upscale_factor=0.5)])
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


# ------------------------------------------------------------ live serve
def _wait(pred, timeout_s, msg):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(msg)


def _autoscale_rows(pkg):
    """Every applied target change lands a serve.autoscale flight-recorder
    row, and serve.status() carries the autoscale block."""
    fresh_init(pkg, num_cpus=8)
    serve = importlib.import_module(f"{pkg.__name__}.serve")
    flight_recorder = importlib.import_module(
        f"{pkg.__name__}.util.flight_recorder")
    try:
        serve.start(http_options={"port": 0})
        asc = serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, metrics_interval_s=0.05,
            upscale_delay_s=0.0, upscale_cooldown_s=0.0,
            target_ongoing_requests=1.0, use_slo_burn=False)

        @serve.deployment(autoscaling_config=asc)
        class Busy:
            def __call__(self, x):
                time.sleep(0.3)
                return x

        handle = serve.run(Busy.bind(), name="busy-parity", route_prefix=None)
        dep = "busy-parity#Busy"
        first = handle.remote(0).result(timeout_s=30)
        futs = [handle.remote(i) for i in range(12)]
        _wait(lambda: serve.status()[dep]["target_num_replicas"] > 1, 30,
              "load never moved the target")
        answers = [f.result(timeout_s=30) for f in futs]
        rows = [e for e in flight_recorder.get_recorder().snapshot()
                if e.get("name") == "serve.autoscale"
                and e.get("detail", {}).get("deployment") == dep]
        up = rows[0]["detail"]
        auto = serve.status()[dep]["autoscale"]
        return [first, answers, up["to"] > up["from"], up["reason"],
                rows[0]["kind"], auto["min_replicas"], auto["max_replicas"],
                auto["last_decision_reason"] is not None,
                auto["last_change_at"] is not None]
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


def test_autoscale_status_and_flight_recorder_rows():
    with gc_paused():
        ref = _autoscale_rows(ray_tpu)
    port = _autoscale_rows(ray_tpu_torch)
    assert ref == [0, list(range(12)), True, "queue_depth", "autoscale", 1,
                   3, True, True]
    assert port == ref


def _injected_autoscale_failures(pkg):
    """tests/test_serve_chaos.py's ``serve_autoscale=1.0:4`` case: while the
    injection budget lasts, every decision the controller would apply is
    rejected, counted under ``fault_injected``, and the target and the
    replica set stay where they were; once it runs out, the scale-up
    applies."""
    fresh_init(pkg, num_cpus=8,
               _system_config={"testing_rpc_failure": "serve_autoscale=1.0:4"})
    serve = importlib.import_module(f"{pkg.__name__}.serve")
    autoscaling = _mod(pkg.__name__, "autoscaling")
    faults = importlib.import_module(f"{pkg.__name__}._private.fault_injection")
    config = importlib.import_module(f"{pkg.__name__}._private.config")
    try:
        serve.start(http_options={"port": 0})
        asc = serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, metrics_interval_s=0.05,
            upscale_delay_s=0.0, upscale_cooldown_s=0.0,
            target_ongoing_requests=1.0, use_slo_burn=False)

        @serve.deployment(autoscaling_config=asc)
        class Slow:
            def __call__(self, x):
                time.sleep(0.3)
                return x

        handle = serve.run(Slow.bind(), name="aschaos-parity",
                           route_prefix=None)
        dep = "aschaos-parity#Slow"
        tags = {"deployment": dep, "reason": "fault_injected"}
        base = autoscaling.DECISIONS.get(tags=tags)

        def rejected():
            return autoscaling.DECISIONS.get(tags=tags) - base

        # (target, replica rows) sampled while the budget lasts; a sample is
        # kept only if no decision was rejected while it was taken, so a
        # budget-exhausting tick between the reads cannot count a rightful
        # scale-up against the injection.
        held = set()

        def sample():
            before = rejected()
            target = serve.status()[dep]["target_num_replicas"]
            rows = sum(r["deployment_id"] == dep
                       for r in serve.list_replicas())
            if rejected() == before < 4:
                held.add((target, rows))

        first = handle.remote(0).result(timeout_s=30)
        sample()
        futs = [handle.remote(i) for i in range(24)]
        deadline = time.time() + 30
        while time.time() < deadline and rejected() < 4:
            sample()
            time.sleep(0.02)
        _wait(lambda: serve.status()[dep]["target_num_replicas"] > 1, 30,
              "the scale-up never applied once the budget ran out")
        answers = [f.result(timeout_s=30) for f in futs]
        draining = [r for r in serve.list_replicas()
                    if r["deployment_id"] == dep and r["state"] == "DRAINING"]
        return [first, sorted(held), rejected(), answers, draining]
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()
            config.GLOBAL_CONFIG.testing_rpc_failure = ""
            faults.reset_injector()


def test_injected_autoscale_failures_leave_target_unchanged():
    with gc_paused():
        ref = _injected_autoscale_failures(ray_tpu)
    port = _injected_autoscale_failures(ray_tpu_torch)
    assert ref == [0, [(1, 1)], 4, list(range(24)), []]
    assert port == ref


class _Request:
    """What the HTTP proxy hands a replica: the JSON body."""

    def __init__(self, body):
        self._body = body

    async def json(self):
        return self._body


def _drive(handle, bodies, clients, until, timeout_s):
    """``clients`` threads send ``bodies`` round-robin through the handle
    until ``until()`` holds; each answer (or error type) per body index."""
    stop = threading.Event()
    answers = []
    lock = threading.Lock()

    def client(k):
        i = k
        while not stop.is_set():
            body = bodies[i % len(bodies)]
            try:
                out = handle.remote(_Request(body)).result(timeout_s=30)
            except Exception as e:  # noqa: BLE001 — counted, then compared
                out = type(e).__name__
            with lock:
                answers.append((i % len(bodies), out))
            i += clients

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    try:
        _wait(until, timeout_s, "the controller made no decision")
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    return answers


def _decisions_for(flight_recorder, dep):
    return [e["detail"] for e in flight_recorder.get_recorder().snapshot()
            if e.get("name") == "serve.autoscale"
            and e.get("detail", {}).get("deployment") == dep]


def _processed(handle, n):
    """The requests each of the deployment's ``n`` running replicas has
    answered, read from the replicas themselves."""
    scheduler = handle._get_router()._scheduler
    _wait(lambda: len(scheduler._replicas) >= n, 30,
          f"the router never saw {n} replicas")
    with scheduler._lock:
        actors = [r["actor"] for r in scheduler._replicas]
    return [m["num_processed_requests"] for m in ray_tpu_torch.get(
        [a.get_metadata.remote() for a in actors], timeout=30)]


def test_gpt2_scales_out_on_request_rate_and_on_slo_burn(monkeypatch,
                                                         tmp_path):
    """The port's controller end to end with GPT-2 (tiny, on the CPU): a
    deployment scales 1 -> 2 on ``"target_qps"`` and both replicas answer;
    another scales 1 -> 2 on ``"slo_burn"`` from real errors (requests one
    token too long), its upscale delay far away, and leaves a postmortem."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.serve import GPT2Next
    from ray_tpu_torch.serve.slo import SLOObjective
    from ray_tpu_torch.util import flight_recorder

    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_MIN_INTERVAL_S", "0")
    config = gpt2.GPTConfig.tiny()
    params = gpt2.init_params(config, 0, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, config.vocab_size, n).tolist()
               for n in rng.integers(1, config.seq_len + 1, 16)]
    local = GPT2Next(config, device="cpu", params=params)
    with torch.inference_mode():
        expected = [local.next_token(p) for p in prompts]
    fresh_init(ray_tpu_torch, num_cpus=8)
    serve = ray_tpu_torch.serve
    serve.slo._reset_watchdog()
    try:
        serve.start(http_options={"port": 0})
        # Target qps: 8 clients of the tiny model far outrun 5/s a replica.
        # A replica is sized for 16 in flight, so that the queue-depth
        # policy (composed with the others by max) asks for one replica
        # and the decision, with its reason, is the policy under test's.
        h_qps = serve.run(serve.deployment(
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=1, max_replicas=2, target_qps_per_replica=5.0,
                target_ongoing_requests=16.0,
                qps_window_s=2.0, metrics_interval_s=0.1,
                upscale_delay_s=0.3, downscale_delay_s=600.0,
                use_slo_burn=False))(GPT2Next).bind(
                    config, device="cpu", params=params),
            name="tq", route_prefix=None)
        bodies = [{"tokens": p} for p in prompts]
        dep = "tq#GPT2Next"
        answers = _drive(h_qps, bodies, 8, lambda: any(
            d["reason"] == "target_qps"
            for d in _decisions_for(flight_recorder, dep)), 60)
        (up,) = _decisions_for(flight_recorder, dep)
        assert (up["from"], up["to"], up["reason"]) == (1, 2, "target_qps")
        _wait(lambda: serve.status()[dep]["running_replicas"] == 2, 60,
              "the second replica never ran")
        answers += _drive(h_qps, bodies, 8,
                          lambda: min(_processed(h_qps, 2)) > 0, 60)
        assert all(out == {"next_token": expected[i]}
                   for i, out in answers)

        # SLO burn: every third request is one token too long, a real
        # error through the router's RED counters.
        h_burn = serve.run(serve.deployment(
            autoscaling_config=serve.AutoscalingConfig(
                min_replicas=1, max_replicas=2, metrics_interval_s=0.1,
                target_ongoing_requests=16.0, upscale_delay_s=60.0,
                use_slo_burn=True))(GPT2Next).bind(
                    config, device="cpu", params=params),
            name="burn", route_prefix=None)
        dep = "burn#GPT2Next"
        serve.slo.get_watchdog().set_objectives(dep, [SLOObjective(
            "availability", target=0.9, fast_window_s=1.0, slow_window_s=3.0,
            burn_threshold=2.0)])
        too_long = {"tokens": [1] * (config.seq_len + 1)}
        order = [None if i % 3 == 2 else i for i in range(24)]
        bodies = [too_long if i is None else {"tokens": prompts[i % 16]}
                  for i in order]
        t0 = time.time()
        answers = _drive(h_burn, bodies, 4, lambda: any(
            d["reason"] == "slo_burn"
            for d in _decisions_for(flight_recorder, dep)), 30)
        assert time.time() - t0 < 60.0  # well before the upscale delay
        (up,) = _decisions_for(flight_recorder, dep)
        assert (up["from"], up["to"], up["reason"]) == (1, 2, "slo_burn")
        for i, out in answers:
            assert out == ("TaskError" if order[i] is None else
                           {"next_token": expected[order[i] % 16]})
        row = serve.status()[dep]["slo"]["objectives"]["availability"]
        assert row["events_slow"] > 0
        assert list(tmp_path.glob("*-slo_breach.json"))
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
            serve.slo._reset_watchdog()
