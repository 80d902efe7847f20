"""The port's latency attribution and SLO burn-rate watchdog
(ray_tpu_torch.serve.llm.attribution, ray_tpu_torch.serve.slo) against the
reference (ray_tpu.serve), on every case of tests/test_serve_slo.py.

Each case runs on both packages with the same inputs under a deterministic
clock (every timestamp is passed in), and the observations must be equal:
exactly for decisions, counts, alert state, span names and bucket values,
and ``SLOWatchdog.evaluate``'s payload key for key. The one place the port
departs from the reference on purpose is the wall ``record_ttft`` reports:
the reference adds the buckets in a plain loop, which since Python 3.12 is
not always ``sum(split.values())`` (the built-in ``sum`` compensates), so
its bit-exact contract fails; the port takes the built-in ``sum``. There
the port's wall is held to the reference's within 4 ulps and every bucket
exactly. The serve cases run the reference, then the port, never both at
once (tests/_torch_runtimes.py).
"""

import importlib
import json
import math
import random
import time
import types
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve  # noqa: F401 — registers the reference's modules
import ray_tpu_torch.serve  # noqa: F401

from _torch_runtimes import fresh_init, gc_paused

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: The port's wall against the reference's, where their sums may differ.
WALL_ULPS = 4


def _pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        name=name, root=imp(name), serve=imp(f"{name}.serve"),
        attr=imp(f"{name}.serve.llm.attribution"),
        slo=imp(f"{name}.serve.slo"),
        tracing=imp(f"{name}.util.tracing"),
        metrics=imp(f"{name}.util.metrics"),
        agg=imp(f"{name}.util.metrics_agent").get_aggregator(),
        profiling=imp(f"{name}._private.profiling"),
        agent=imp(f"{name}._private.metrics_agent"),
        runtime=imp(f"{name}._private.runtime"))


def _both(case, *args):
    return [case(_pkg(name), *args) for name in PACKAGES]


@pytest.fixture
def postmortems(monkeypatch, tmp_path):
    """Breach dumps land in a temporary directory, for both packages, with
    no flood control between cases."""
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_MIN_INTERVAL_S", "0")
    return tmp_path


@pytest.fixture
def tracing_off():
    yield
    for name in PACKAGES:
        t = _pkg(name).tracing
        t.disable_tracing()
        t.clear_spans()


def _spans(p, prefix):
    return [(s["name"], s["start"], s["end"], s["status"], s["attributes"])
            for s in p.tracing.exported_spans()
            if s["name"].startswith(prefix)]


# ----------------------------------------------------------- split_wall
SPLITS = {
    "buckets_sum_to_wall": (1.0, {"queue": 0.3, "admission": 0.2,
                                  "prefill": 0.4, "handoff": 0.05}),
    "overmeasured_buckets_capped_in_order": (
        0.5, {"queue": 0.4, "admission": 0.3, "prefill": 0.2}),
    "negative_wall_clamps_to_zero": (-0.5, {"queue": 0.1}),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_wall_matches_reference(name):
    wall, buckets = SPLITS[name]
    ref, port = _both(lambda p: p.attr.split_wall(wall, buckets))
    assert port == ref
    assert sum(port.values()) == pytest.approx(max(0.0, wall), rel=1e-12)
    if name == "overmeasured_buckets_capped_in_order":
        assert port == {"queue": 0.4, "admission": pytest.approx(0.1),
                        "prefill": 0.0, "handoff": 0.0, "residual": 0.0}
    if name == "buckets_sum_to_wall":
        assert port["residual"] == pytest.approx(0.05)


def _random_measures(n=200, seed=0):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        wall = rng.uniform(0.0, 2.0)
        buckets = {b: rng.uniform(-0.1, 1.0)
                   for b in ("queue", "admission", "prefill", "handoff")
                   if rng.random() < 0.8}
        out.append((wall, buckets))
    return out


def test_recorded_wall_is_bit_exact_sum_under_random_measures():
    """The reference's own test, on the port: whatever the measured
    buckets, the wall record_ttft reports IS ``sum`` of the split."""
    attr = _pkg("ray_tpu_torch").attr
    for wall, buckets in _random_measures():
        split = attr.split_wall(wall, buckets)
        assert all(v >= 0.0 for v in split.values())
        assert sum(split.values()) == pytest.approx(wall, rel=1e-12)
        rec = attr.record_ttft(wall, buckets, deployment="parity-dep-rand",
                               pool="mono")
        assert sum(rec.values()) == attr.recent_ttft()[-1]["wall"]


def test_recorded_wall_matches_reference_within_ulps():
    """Same measures through both packages: every bucket equal, the walls
    within WALL_ULPS (the reference's plain loop against ``sum``)."""
    measures = _random_measures(n=2000, seed=1)

    def record(p):
        out = []
        for wall, buckets in measures:
            split = p.attr.record_ttft(wall, buckets,
                                       deployment="parity-dep-ulps",
                                       pool="mono")
            out.append((split, p.attr.recent_ttft()[-1]["wall"]))
        return out

    ref, port = _both(record)
    for (rsplit, rwall), (psplit, pwall) in zip(ref, port):
        assert psplit == rsplit
        assert abs(pwall - rwall) <= WALL_ULPS * math.ulp(rwall)
        assert pwall == sum(psplit.values())


# -------------------------------------------------- RequestAttribution
def _lifecycle(p):
    a = p.attr.RequestAttribution(pool="mono", deployment="parity-dep-life",
                                  t_submit=100.0)
    a.on_added(100.2)
    a.on_admitted(100.5)
    a.on_prefill(0.4)
    a.on_handoff(0.05)
    a.on_emit(101.0)  # first token: finalizes the TTFT
    rec = p.attr.recent_ttft()[-1]
    a.on_emit(101.1)  # an inter-token gap, not another TTFT
    gaps = p.agg.window_values("ray_tpu_llm_inter_token_seconds",
                               {"deployment": "parity-dep-life"},
                               window_s=3600.0)
    return rec, gaps


def test_lifecycle_buckets_and_recent_record():
    (rrec, rgaps), (prec, pgaps) = _both(_lifecycle)
    assert rrec["deployment"] == "parity-dep-life"
    assert rrec["wall"] == pytest.approx(1.0)
    b = rrec["buckets"]
    assert b["queue"] == pytest.approx(0.2)
    assert b["admission"] == pytest.approx(0.3)
    assert b["prefill"] == pytest.approx(0.4)
    assert b["handoff"] == pytest.approx(0.05)
    assert len(rgaps) == 1 and rgaps[0] == pytest.approx(0.1)
    assert prec["buckets"] == rrec["buckets"]
    assert abs(prec["wall"] - rrec["wall"]) <= WALL_ULPS * math.ulp(1.0)
    assert sum(prec["buckets"].values()) == prec["wall"]
    assert {k: prec[k] for k in ("deployment", "pool")} == \
        {k: rrec[k] for k in ("deployment", "pool")}
    assert pgaps == rgaps


def _preemption(p):
    a = p.attr.RequestAttribution(pool="decode", deployment="parity-dep-pre",
                                  t_submit=10.0)
    a.on_added(10.1)
    a.on_admitted(10.2)
    a.on_preempted(15.0)  # blocks reclaimed mid-decode
    a.on_admitted(15.5)   # requeued wait is 0.5s, NOT 5.3s
    return a.preemptions, dict(a.buckets)


def test_preemption_rearms_admission_mark():
    ref, port = _both(_preemption)
    assert ref[0] == 1
    assert ref[1]["admission"] == pytest.approx(0.1 + 0.5)
    assert port == ref


def _decode_pool(p):
    before = p.attr.recent_ttft()
    a = p.attr.RequestAttribution(pool="decode", deployment="parity-dep-dec",
                                  t_submit=50.0, request_level=False)
    a.on_added(50.1)
    a.on_emit(50.2)  # resumed sequence's first local emission
    skipped = p.attr.recent_ttft() == before  # the frontend owns the TTFT
    a.on_emit(50.3)
    return skipped, len(p.agg.window_values(
        "ray_tpu_llm_inter_token_seconds", {"deployment": "parity-dep-dec"},
        window_s=3600.0))


def test_decode_pool_sequence_skips_request_level_ttft():
    ref, port = _both(_decode_pool)
    assert ref == (True, 1)
    assert port == ref


def _ttft_spans(p):
    p.tracing.clear_spans()
    p.tracing.enable_tracing()
    ctx = {"trace_id": "t" * 32, "span_id": "parent-span"}
    split = p.attr.record_ttft(
        1.0, {"queue": 0.2, "admission": 0.3, "prefill": 0.4},
        deployment="parity-dep-span", pool="mono", trace_ctx=ctx,
        start=100.0)
    spans = [s for s in p.tracing.exported_spans()
             if s["name"].startswith("serve.ttft_")]
    p.tracing.disable_tracing()
    p.tracing.clear_spans()
    return split, [(s["name"], s["start"], s["end"], s["trace_id"],
                    s["parent_id"], s["attributes"]) for s in spans]


def test_ttft_spans_contiguous_under_parent(tracing_off):
    (rsplit, rspans), (psplit, pspans) = _both(_ttft_spans)
    assert [s[0] for s in rspans] == [
        "serve.ttft_queue", "serve.ttft_admission", "serve.ttft_prefill",
        "serve.ttft_residual"]
    # Contiguous: each span starts where the previous ended.
    t = 100.0
    for _, start, end, trace_id, parent_id, _ in pspans:
        assert start == pytest.approx(t)
        assert trace_id == "t" * 32 and parent_id == "parent-span"
        t = end
    assert t == pytest.approx(100.0 + sum(psplit.values()))
    assert psplit == rsplit
    assert pspans == rspans


def _disabled(p):
    before = p.attr.recent_ttft()
    p.attr.set_enabled(False)
    try:
        off = p.attr.is_enabled()
    finally:
        p.attr.set_enabled(True)
    return off, p.attr.is_enabled(), p.attr.recent_ttft() == before


def test_disabled_layer_emits_nothing():
    ref, port = _both(_disabled)
    assert ref == (False, True, True)
    assert port == ref


def _recompute(p):
    p.tracing.clear_spans()
    p.tracing.enable_tracing()
    ctx = {"trace_id": "r" * 32, "span_id": "root"}
    a = p.attr.RequestAttribution(pool="decode", deployment="parity-dep-rec",
                                  t_submit=0.0, trace_ctx=ctx)
    registry = p.metrics.registry()
    before = _counter(registry, "ray_tpu_llm_recompute_tokens_total",
                      "decode")
    a.on_recompute(0.2, tokens=12, now=10.0)
    after = _counter(registry, "ray_tpu_llm_recompute_tokens_total",
                     "decode")
    spans = _spans(p, "serve.preempt_recompute")
    p.tracing.disable_tracing()
    p.tracing.clear_spans()
    return dict(a.buckets), after - before, spans


def _counter(registry, name, pool):
    return sum(v for group in registry.collect() if group[0].name == name
               for m in group for _, tags, v in m.samples()
               if tags.get("pool") == pool)


def test_recompute_counts_waste_and_span(tracing_off):
    ref, port = _both(_recompute)
    assert ref[0]["prefill"] == pytest.approx(0.2)
    assert ref[1] == 12
    assert len(ref[2]) == 1 and ref[2][0][4]["tokens"] == 12
    assert ref[2][0][1] == pytest.approx(9.8)
    assert port == ref


# ------------------------------------------------------- SLO objectives
OBJECTIVE_ERRORS = [
    (dict(name="p50_vibes"), "unknown SLO objective"),
    (dict(name="ttft_p99_ms", target=1.0), "target"),
    (dict(name="ttft_p99_ms", target=0.0), "target"),
    (dict(name="availability", fast_window_s=60.0, slow_window_s=30.0),
     "slow_window_s"),
]


@pytest.mark.parametrize("kwargs,match", OBJECTIVE_ERRORS,
                         ids=["unknown", "target_one", "target_zero",
                              "window_order"])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_objective_rejects_bad_shapes(pkg, kwargs, match):
    with pytest.raises(ValueError, match=match):
        _pkg(pkg).slo.SLOObjective(**kwargs)


def test_registry_names_construct():
    ref, port = _both(lambda p: [(n, p.slo.SLOObjective(name=n).target)
                                 for n in sorted(p.slo.SLO_OBJECTIVES)])
    assert port == ref
    assert _pkg("ray_tpu_torch").slo.SLO_OBJECTIVES == \
        _pkg("ray_tpu").slo.SLO_OBJECTIVES


# -------------------------------------------------------- SLOWatchdog
#: One clock for both packages, so the payloads' ``since`` agree.
BASE = time.time()


def _feed_ttft(p, dep, ts, value, n=1):
    for i in range(n):
        p.agg.observe("ray_tpu_llm_ttft_seconds", value,
                      {"deployment": dep, "pool": "mono"}, kind="value",
                      ts=ts + i * 0.01)


def _ttft_objective(p):
    return p.slo.SLOObjective(
        name="ttft_p99_ms", target=0.9, threshold_ms=100.0,
        fast_window_s=30.0, slow_window_s=300.0, burn_threshold=2.0)


def _burn_episode(p):
    dep = "parity-slo-burn"
    wd = p.slo.SLOWatchdog()
    wd.set_objectives(dep, [_ttft_objective(p)])
    p.tracing.clear_spans()
    p.tracing.enable_tracing()
    outs = []
    _feed_ttft(p, dep, BASE - 200.0, 0.02, n=10)  # healthy
    outs.append((wd.evaluate(now=BASE - 190.0), wd.alerting(dep)))
    _feed_ttft(p, dep, BASE - 100.0, 0.50, n=40)  # every request too slow
    outs.append((wd.evaluate(now=BASE - 95.0), wd.alerting(dep)))
    _feed_ttft(p, dep, BASE - 20.0, 0.02, n=10)   # recovery
    outs.append((wd.evaluate(now=BASE - 10.0), wd.alerting(dep)))
    burns = _spans(p, "serve.slo_burn")
    p.tracing.disable_tracing()
    p.tracing.clear_spans()
    return outs, burns


def test_burn_fires_both_windows_then_clears_with_span(postmortems,
                                                       tracing_off):
    ref, port = _both(_burn_episode)
    (healthy, _), (storm, alerting), (recovered, after) = ref[0]
    dep = "parity-slo-burn"
    row = healthy[dep]["objectives"]["ttft_p99_ms"]
    assert not row["alerting"] and row["burn_fast"] == 0.0
    row = storm[dep]["objectives"]["ttft_p99_ms"]
    assert row["alerting"] and storm[dep]["alerting"] and alerting
    assert row["burn_fast"] >= 2.0 and row["burn_slow"] >= 2.0
    assert row["since"] == pytest.approx(BASE - 95.0)
    row = recovered[dep]["objectives"]["ttft_p99_ms"]
    assert not row["alerting"] and row["since"] is None and not after
    assert row["burn_slow"] >= 2.0  # the asymmetry under test
    (burn,) = ref[1]
    assert burn[3] == "ERROR: SLOBurn"
    assert burn[4]["deployment"] == dep
    assert burn[4]["objective"] == "ttft_p99_ms"
    assert burn[1:3] == (pytest.approx(BASE - 95.0),
                         pytest.approx(BASE - 10.0))
    assert port == ref
    # The breach left a postmortem from each package.
    assert len(list(postmortems.glob("*-slo_breach.json"))) >= 1


def _blip(p):
    dep = "parity-slo-blip"
    wd = p.slo.SLOWatchdog()
    wd.set_objectives(dep, [_ttft_objective(p)])
    _feed_ttft(p, dep, BASE - 280.0, 0.02, n=95)
    _feed_ttft(p, dep, BASE - 10.0, 0.50, n=5)
    return wd.evaluate(now=BASE - 5.0)


def test_slow_window_vetoes_single_blip():
    ref, port = _both(_blip)
    row = ref["parity-slo-blip"]["objectives"]["ttft_p99_ms"]
    assert row["burn_fast"] >= 2.0 and row["burn_slow"] < 2.0
    assert not row["alerting"]
    assert port == ref


def _quiet(p):
    wd = p.slo.SLOWatchdog()
    wd.set_objectives("parity-slo-quiet", [
        p.slo.SLOObjective(name="ttft_p99_ms"),
        p.slo.SLOObjective(name="availability")])
    return wd.evaluate(now=BASE)


def test_no_traffic_is_budget_neutral():
    ref, port = _both(_quiet)
    for row in ref["parity-slo-quiet"]["objectives"].values():
        assert not row["alerting"]
        assert row["events_fast"] == 0 and row["burn_fast"] == 0.0
    assert port == ref


def _availability(p):
    dep = "parity-slo-avail"
    # Cumulative counters: 100 requests, 30 errors over the window.
    for i, (total, errs) in enumerate(((0.0, 0.0), (100.0, 30.0))):
        for name, v in (("serve_requests_total", total),
                        ("serve_request_errors_total", errs)):
            p.agg.observe(name, v, {"deployment": dep}, kind="counter",
                          ts=BASE - 20.0 + 10.0 * i)
    wd = p.slo.SLOWatchdog()
    wd.set_objectives(dep, [p.slo.SLOObjective(
        name="availability", target=0.9, fast_window_s=30.0,
        slow_window_s=30.0, burn_threshold=2.0)])
    return wd.evaluate(now=BASE - 10.0 + 30.0 - 29.0)


def test_availability_reads_red_counters(postmortems):
    ref, port = _both(_availability)
    row = ref["parity-slo-avail"]["objectives"]["availability"]
    assert row["bad_fraction_fast"] == pytest.approx(0.3, abs=0.01)
    assert row["alerting"]  # burn = 0.3 / 0.1 = 3 >= 2 on both windows
    assert port == ref


def _clear(p):
    wd = p.slo.SLOWatchdog()
    wd.set_objectives("a", [p.slo.SLOObjective(name="availability")])
    wd.set_objectives("b", [p.slo.SLOObjective(name="availability")])
    out = [wd.deployments()]
    wd.clear_objectives("a")
    out.append(wd.deployments())
    wd.clear_objectives()
    return out + [wd.has_objectives()]


def test_clear_objectives_drops_state():
    ref, port = _both(_clear)
    assert ref == [["a", "b"], ["b"], False]
    assert port == ref


# ------------------------------------------------- serve.status + route
def _status_and_route(pkg):
    p = _pkg(pkg)
    p.slo._reset_watchdog()
    fresh_init(p.root, num_cpus=4)
    p.serve.start(http_options={"port": 0})
    try:
        @p.serve.deployment
        class Probe:
            async def __call__(self, x):
                return x

        handle = p.serve.run(Probe.bind(), name="slo-parity",
                             route_prefix=None)
        answer = handle.remote(7).result(timeout_s=30)
        p.slo.get_watchdog().set_objectives("slo-parity#Probe", [
            p.slo.SLOObjective(name="availability"),
            p.slo.SLOObjective(name="ttft_p99_ms", threshold_ms=500.0)])
        st = p.serve.status()["slo-parity#Probe"]["slo"]
        agent = p.agent.MetricsAgent(p.runtime.get_runtime())
        try:
            payload = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{agent.port}/api/serve/slo", timeout=10))
        finally:
            agent.stop()
        dep = payload["deployments"]["slo-parity#Probe"]
        keys = ("target", "threshold_ms", "fast_window_s", "slow_window_s",
                "burn_threshold", "alerting")
        return [answer, sorted(st["objectives"]), st["alerting"],
                payload["objectives_registry"], sorted(dep["objectives"]),
                dep["alerting"],
                {n: {k: o[k] for k in keys}
                 for n, o in dep["objectives"].items()}]
    finally:
        p.serve.shutdown()
        p.root.shutdown()
        p.slo._reset_watchdog()


def test_status_and_slo_route_carry_evaluation():
    """serve.status() gains an "slo" entry for deployments with
    objectives, and each package's metrics agent serves the watchdog's
    payload at /api/serve/slo."""
    with gc_paused():
        ref = _status_and_route("ray_tpu")
    port = _status_and_route("ray_tpu_torch")
    assert ref[:6] == [7, ["availability", "ttft_p99_ms"], False,
                       sorted(ray_tpu.serve.slo.SLO_OBJECTIVES),
                       ["availability", "ttft_p99_ms"], False]
    assert port == ref


# ------------------------------------------------- timeline lane fusion
LANE_SPANS = [
    {"name": "serve.slo_burn", "trace_id": "a" * 32, "span_id": "1",
     "parent_id": None, "start": 1.0, "end": 2.0,
     "attributes": {}, "status": "ERROR: SLOBurn"},
    {"name": "serve.preempt_recompute", "trace_id": "b" * 32,
     "span_id": "2", "parent_id": None, "start": 1.2, "end": 1.4,
     "attributes": {}, "status": "OK"},
    {"name": "serve.ttft_prefill", "trace_id": "c" * 32, "span_id": "3",
     "parent_id": None, "start": 1.0, "end": 1.1,
     "attributes": {}, "status": "OK"},
    {"name": "train.step", "trace_id": "d" * 32, "span_id": "4",
     "parent_id": None, "start": 1.0, "end": 1.5,
     "attributes": {}, "status": "OK"},
]


def test_slo_and_recompute_spans_share_serve_lane():
    """SLO burn episodes and preemption recomputes fold into the single
    "serve" pid of the Perfetto timeline."""
    ref, port = _both(
        lambda p: p.profiling.spans_to_chrome_events(LANE_SPANS))
    events = {e["name"]: e for e in port}
    assert events["serve.slo_burn"]["pid"] == "serve"
    assert events["serve.preempt_recompute"]["pid"] == "serve"
    assert events["serve.slo_burn"]["cname"] == "terrible"
    assert events["serve.ttft_prefill"]["pid"].startswith("trace:")
    assert events["train.step"]["pid"] == "train"
    assert port == ref
