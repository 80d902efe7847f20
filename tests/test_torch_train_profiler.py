"""The port's step profiler, train metrics, run registry and hang watchdog
(ray_tpu_torch.train.profiler, .train.metrics, .train.run_registry,
.util.watchdog) against the reference's, on the cases of
tests/test_train_profiler.py (``TestCounterZeroInc``, ``TestStepProfiler``,
``TestProfilerHooks``, ``TestRunRegistry``) and the watchdog cases of
tests/test_forensics.py (``TestWatchdog``).

Each case is one body run against both packages' modules, under the same
deterministic clock: what each returns must be equal. The reference's
``list_train_runs`` state API is not ported (ROADMAP.md, Queue 1 item 15):
the port's half reads the same rows from ``run_registry``. Then the port's
own: the streaming ingest's ``data_wait`` landing in a live train worker's
profiler, and each rank's collective wait in its ``collective`` bucket;
and the reference's timeline fusion of an elastic fit, on the port alone
(its loop in torch), once a step has committed.
"""

import importlib
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init

PKGS = ("ray_tpu", "ray_tpu_torch")


class Mods:
    """One package's modules under test."""

    def __init__(self, name):
        imp = importlib.import_module
        self.name = name
        self.um = imp(name + ".util.metrics")
        self.tracing = imp(name + ".util.tracing")
        self.profiler = imp(name + ".train.profiler")
        self.metrics = imp(name + ".train.metrics")
        self.registry = imp(name + ".train.run_registry")
        self.prefetch = imp(name + ".data.ingest.prefetch")
        self.watchdog = imp(name + ".util.watchdog")
        self.recorder = imp(name + ".util.flight_recorder")
        self.StepProfiler = self.profiler.StepProfiler

    def list_train_runs(self, status=None):
        if self.name == "ray_tpu":
            from ray_tpu.util import state

            return state.list_train_runs(
                filters=[("status", "=", status)] if status else None)
        rows = self.registry.list_runs()
        return [r for r in rows if status is None or r["status"] == status]


def both(case):
    out = []
    for name in PKGS:
        out.append(case(Mods(name)))
    return out


def _approx(x):
    """Floats rounded to 9 places, so the two halves compare exactly."""
    if isinstance(x, dict):
        return {k: _approx(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_approx(v) for v in x]
    if isinstance(x, float):
        return round(x, 9)
    return x


def check(case):
    ref, port = both(case)
    assert _approx(ref) == _approx(port)
    return port


# ------------------------------------------------- Counter.inc(0): a no-op
def inc_zero_is_noop(m):
    c = m.um.Counter(f"test_zero_inc_total_{id(m)}", "zero-inc contract")
    c.inc(0)
    out = [c.get()]
    c.inc(2)
    c.inc(0)
    return out + [c.get()]


def negative_still_raises(m):
    c = m.um.Counter(f"test_neg_inc_total_{id(m)}", "negatives stay fatal")
    out = []
    for v in (-1, -0.5):
        try:
            c.inc(v)
            out.append(None)
        except ValueError:
            out.append("ValueError")
    return out


# ----------------------------------------------------- StepProfiler cases
def buckets_sum_to_wall_by_construction(m):
    p = m.StepProfiler(run_name="t", rank=0)
    p.start(now=100.0)
    p.record("data_wait", 100.0, 100.3)
    p.record("h2d", 100.3, 100.4)
    p.record("collective", 100.6, 100.8)
    row = p.step_boundary(now=101.0)
    measured = sum(row[b] for b in m.profiler.BUCKETS)
    return [row, measured + row["compute"], list(m.profiler.BUCKETS)]


def overlong_bucket_clamped_and_compute_floored(m):
    p = m.StepProfiler()
    p.start(now=10.0)
    p.record("data_wait", 9.0, 12.0)
    return p.step_boundary(now=11.0)


def boundary_resets_and_steps_advance(m):
    p = m.StepProfiler()
    p.start(now=0.0)
    p.record("data_wait", 0.0, 0.5)
    r0 = p.step_boundary(now=1.0)
    r1 = p.step_boundary(now=2.0)
    return [r0, r1, len(p.history), p.last_attribution()["step"]]


def zero_or_negative_window_returns_none(m):
    p = m.StepProfiler()
    never = p.step_boundary(now=5.0)
    p.start(now=5.0)
    return [never, p.step_boundary(now=5.0)]


def gauges_refresh_on_boundary(m):
    p = m.StepProfiler(flops_per_step=2e9, tokens_per_step=1000,
                       peak_flops=1e12)
    p.start(now=0.0)
    p.record("data_wait", 0.0, 0.5)
    p.step_boundary(now=2.0)
    tm = m.metrics
    return [tm.DATA_STARVED_FRACTION.get(), tm.TOKENS_PER_SECOND.get(),
            tm.MFU.get(), tm.STEP_P50_SECONDS.get(),
            tm.STEP_BUCKET_SECONDS.get({"bucket": "data_wait"})]


def spans_parent_under_train_step(m):
    tracing = m.tracing
    tracing.clear_spans()
    tracing.enable_tracing()
    try:
        p = m.StepProfiler(run_name="spantest", rank=3)
        p.start(now=50.0)
        p.record("data_wait", 50.0, 50.2)
        p.record("collective", 50.4, 50.5)
        p.step_boundary(now=51.0)
        spans = {s["name"]: s for s in tracing.exported_spans()}
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()
    parent = spans["train.step"]
    return [sorted(spans), parent["attributes"]["rank"],
            [spans[c]["parent_id"] == parent["span_id"]
             and spans[c]["trace_id"] == parent["trace_id"]
             for c in ("train.data_wait", "train.collective", "train.compute")]]


def no_spans_when_tracing_off(m):
    m.tracing.clear_spans()
    p = m.StepProfiler()
    p.start(now=0.0)
    p.record("h2d", 0.0, 0.1)
    p.step_boundary(now=1.0)
    return m.tracing.exported_spans()


# -------------------------------------------------------- hook shims
def shim_is_noop_without_active_profiler(m):
    m.profiler.activate(None)
    m.prefetch._profiler_record("data_wait", 0.0, 1.0)  # must not raise
    return m.profiler.active_profiler()


def shim_feeds_active_profiler(m):
    p = m.StepProfiler()
    m.profiler.activate(p)
    try:
        t = 1000.0
        m.prefetch._profiler_record("h2d", t - 0.25, t)
    finally:
        m.profiler.activate(None)
    return p._totals["h2d"]


def starved_prefetcher_records_data_wait(m):
    def slow_src():
        for i in range(3):
            time.sleep(0.08)
            yield i

    p = m.StepProfiler()
    m.profiler.activate(p)
    try:
        items = list(m.prefetch.HostPrefetcher(slow_src(), depth=2))
        row = p.step_boundary()
    finally:
        m.profiler.activate(None)
    return [items, row is not None and row["data_wait"] > 0.05]


# ---------------------------------------------------------- run registry
def registry_lifecycle_and_state_api(m):
    reg = m.registry
    reg.clear()
    try:
        reg.register_run("r1", world_size=4, target_world=4, path="/tmp/r1",
                         elastic=True)
        reg.update_run("r1", world_size=3, last_committed_step=17)
        reg.record_event("r1", {"type": "shrink", "from_world": 4,
                                "to_world": 3})
        (row,) = [r for r in m.list_train_runs() if r["name"] == "r1"]
        out = [row["status"], row["world_size"], row["target_world"],
               row["last_committed_step"], row["events"][0]["type"]]
        reg.finish_run("r1", "finished")
        return out + [reg.get_run("r1")["status"],
                      m.list_train_runs(status="running")]
    finally:
        reg.clear()


def registry_copies_do_not_leak_live_rows(m):
    reg = m.registry
    reg.clear()
    try:
        reg.register_run("r2", world_size=2, target_world=2)
        row = reg.get_run("r2")
        row["world_size"] = 99
        row["events"].append({"type": "bogus"})
        fresh = reg.get_run("r2")
        return [fresh["world_size"], fresh["events"]]
    finally:
        reg.clear()


def registry_unknown_name_update_is_noop(m):
    reg = m.registry
    reg.update_run("ghost", world_size=1)
    reg.record_event("ghost", {"type": "x"})
    reg.finish_run("ghost", "failed")
    return reg.get_run("ghost")


def registry_events_and_finished_rows_bounded(m):
    reg = m.registry
    reg.clear()
    try:
        reg.register_run("big", world_size=1, target_world=1)
        for i in range(reg._MAX_EVENTS + 10):
            reg.record_event("big", {"type": "shrink", "i": i})
        evs = reg.get_run("big")["events"]
        out = [len(evs), evs[-1]["i"]]
        for i in range(reg._MAX_FINISHED + 8):
            reg.register_run(f"f{i}", world_size=1, target_world=1)
            reg.finish_run(f"f{i}", "finished")
        done = [r for r in reg.list_runs() if r["status"] != "running"]
        return out + [len(done), reg.get_run("big") is not None]
    finally:
        reg.clear()


# ----------------------------------------------- hang watchdog (forensics)
@pytest.fixture
def recorder_env(monkeypatch, tmp_path):
    """Isolated postmortem dir + fresh recorder/watchdog singletons of both
    packages, no background detection thread."""
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(tmp_path / "pm"))
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_MIN_INTERVAL_S", "0")
    monkeypatch.setenv("RAY_TPU_HANG_WATCHDOG", "0")
    mods = [Mods(n) for n in PKGS]
    for m in mods:
        m.recorder.reset_recorder()
        m.watchdog.reset_watchdog()
    yield
    for m in mods:
        m.recorder.reset_recorder()
        m.watchdog.reset_watchdog()
        m.tracing.disable_tracing()
        m.tracing.clear_spans()


def beat_stall_one_shot_and_rearm(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=10.0)
    wd.beat("w0", now=0.0)
    out = [wd.tick(now=5.0), wd.tick(now=11.0), wd.tick(now=12.0)]
    wd.beat("w0", now=13.0)
    return out + [wd.tick(now=14.0),
                  [s["kind"] for s in wd.tick(now=30.0)]]


def phase_stall_even_while_beats_continue(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=10.0)
    wd.phase_enter("r0", "rendezvous", now=0.0)
    wd.beat("r0", now=8.0)
    stalls = wd.tick(now=11.0)
    wd.phase_exit("r0", now=12.0)
    return [stalls, wd.tick(now=13.0)]


def quiet_source_retires(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=10.0)
    wd.beat("done", now=0.0)
    return [wd.tick(now=150.0), "done" in wd.straggler_report()]


def forget_drops_source(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=10.0)
    wd.beat("lane", now=0.0)
    wd.forget("lane")
    return wd.tick(now=100.0)


def straggler_flagged_from_dispersion(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=100.0, straggler_factor=2.0)
    for _ in range(5):
        wd.beat("a", wall=1.0, now=0.0)
        wd.beat("b", wall=1.1, now=0.0)
        wd.beat("c", wall=5.0, now=0.0)
    wd.tick(now=1.0)
    return wd.straggler_report()


def single_source_never_a_straggler(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=100.0)
    wd.beat("solo", wall=9.0, now=0.0)
    wd.tick(now=1.0)
    return wd.straggler_report()


def stall_captures_stacks_and_emits_error_span(m):
    rec = m.recorder.get_recorder()
    m.tracing.enable_tracing()
    try:
        wd = m.watchdog.HangWatchdog(stall_threshold_s=5.0)
        wd.phase_enter("w1", "collective", now=100.0)
        stalls = wd.tick(now=200.0)
        rows = [r for r in rec.snapshot() if r["kind"] == "stall"]
        spans = [s for s in m.tracing.exported_spans()
                 if s["name"] == "train.stall"]
    finally:
        m.tracing.disable_tracing()
        m.tracing.clear_spans()
    return [len(stalls), rows[-1]["name"], rows[-1]["status"],
            any("MainThread" in n for n in rows[-1]["detail"]["stacks"]),
            [(s["status"], s["start"], s["end"]) for s in spans]]


def wedged_thread_flagged_while_alive(m):
    wd = m.watchdog.HangWatchdog(stall_threshold_s=0.2)
    release, entered = threading.Event(), threading.Event()

    def wedged_worker():
        wd.phase_enter("wedged", "rendezvous")
        entered.set()
        release.wait(timeout=30)
        wd.phase_exit("wedged")

    t = threading.Thread(target=wedged_worker, daemon=True)
    t.start()
    assert entered.wait(timeout=10)
    try:
        stalls = wd.tick(now=time.time() + 1.0)
        alive = t.is_alive()
    finally:
        release.set()
        t.join(timeout=10)
    return [alive, [s["source"] for s in stalls]]


@pytest.mark.parametrize("case", [
    inc_zero_is_noop, negative_still_raises,
    buckets_sum_to_wall_by_construction,
    overlong_bucket_clamped_and_compute_floored,
    boundary_resets_and_steps_advance, zero_or_negative_window_returns_none,
    gauges_refresh_on_boundary, spans_parent_under_train_step,
    no_spans_when_tracing_off, shim_is_noop_without_active_profiler,
    shim_feeds_active_profiler, starved_prefetcher_records_data_wait,
    registry_lifecycle_and_state_api, registry_copies_do_not_leak_live_rows,
    registry_unknown_name_update_is_noop,
    registry_events_and_finished_rows_bounded,
], ids=lambda f: f.__name__)
def test_matches_reference(case):
    check(case)


@pytest.mark.parametrize("case", [
    beat_stall_one_shot_and_rearm, phase_stall_even_while_beats_continue,
    quiet_source_retires, forget_drops_source,
    straggler_flagged_from_dispersion, single_source_never_a_straggler,
    stall_captures_stacks_and_emits_error_span,
    wedged_thread_flagged_while_alive,
], ids=lambda f: f.__name__)
def test_watchdog_matches_reference(recorder_env, case):
    check(case)


def test_reference_values():
    """The port's numbers are the reference test's, not merely equal to
    whatever the reference gives."""
    m = Mods("ray_tpu_torch")
    row, total, _ = buckets_sum_to_wall_by_construction(m)
    assert row["wall"] == pytest.approx(1.0) and total == pytest.approx(1.0)
    assert row["data_wait"] == pytest.approx(0.3)
    assert gauges_refresh_on_boundary(m) == pytest.approx(
        [0.25, 500.0, 2e9 / 2.0 / 1e12, 2.0, 0.5])
    assert starved_prefetcher_records_data_wait(m) == [[0, 1, 2], True]


# ----------------------------------------------------------- the port's
def test_ingest_data_wait_lands_in_a_live_train_worker_profiler():
    """A CudaTrainer rank reading a streaming dataset whose blocks arrive
    slowly: the ingest's data_wait records reach that rank's profiler, and
    each rank's allreduce wait its collective bucket."""
    from ray_tpu_torch import collective, data, train
    from ray_tpu_torch.train import CudaTrainer, ScalingConfig

    fresh_init(ray_tpu_torch, num_cpus=4)

    def slow(b):
        time.sleep(0.05)
        return {"x": b["id"].astype(np.float32)}

    try:
        ds = data.range(64, parallelism=8).map_batches(slow)

        def loop():
            ctx = train.get_context()
            for batch in train.get_dataset_shard("train").iter_batches(
                    batch_size=8):
                collective.allreduce(np.float32([batch["x"].sum()]),
                                     group_name=ctx.collective_group)
                train.report({"n": len(batch["x"])})

        trainer = CudaTrainer(loop, scaling_config=ScalingConfig(
            num_workers=1, use_gpu=False), datasets={"train": ds})
        result = trainer.fit()
        assert result.error is None, result.error
        rows = list(trainer.sessions[0].profiler.history)
        assert len(rows) == 8
        assert sum(r["data_wait"] for r in rows) > 0.05, rows
        assert all(r["collective"] > 0 for r in rows), rows
        for r in rows:
            parts = sum(r[b] for b in ("data_wait", "h2d", "collective",
                                       "ckpt_block", "compute"))
            assert parts == pytest.approx(r["wall"])
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------- timeline fusion of an elastic fit
def _profiled_loop(config):
    """The reference's ``_profiled_loop`` (tests/test_train_profiler.py) in
    torch: a lockstep sum over the elastic shard, a save every step."""
    import torch

    from ray_tpu_torch import collective, train

    ctx = train.get_context()
    shard = train.get_dataset_shard("train")
    ckpt = train.get_checkpoint()
    step = int(ckpt.to_pytree()["step"]) if ckpt is not None else -1
    w = float(ckpt.to_pytree()["w"]) if ckpt is not None else 0.0
    while True:
        batch = shard.next_batch(config.get("batch", 2))
        n = 0 if batch is None else len(batch[0])
        contrib = 0.0 if batch is None else float(np.sum(batch[1]))
        vec = collective.allreduce(
            torch.tensor([float(n), contrib], dtype=torch.float64),
            group_name=ctx.collective_group)
        if float(vec[0]) == 0:
            break
        w += float(vec[1])
        step += 1
        train.report({"step": step, "w": w, "world": ctx.world_size},
                     checkpoint={"w": torch.tensor(w, dtype=torch.float64),
                                 "step": torch.tensor(step)})
        time.sleep(0.05)


def test_timeline_fuses_train_elastic_and_checkpoint(tmp_path):
    """The reference's timeline-fusion case on the port: one elastic
    shrink -> grow run with tracing on; the exported trace shows steps,
    their data-wait spans nested under them, the elastic recovery with the
    shrink's shape, and checkpoint phases in the "train" lane, and the
    state API tracks the run live and after."""
    import json

    from ray_tpu_torch.autoscaler.elastic import simulate_preemption
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import (CheckpointConfig, CudaTrainer,
                                     ElasticConfig, FailureConfig, RunConfig,
                                     ScalingConfig, run_registry)
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util import tracing

    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 0})
    nodes = [cluster.add_node(num_cpus=1) for _ in range(3)]
    run_registry.clear()
    tracing.clear_spans()
    tracing.enable_tracing()
    try:
        trainer = CudaTrainer(
            _profiled_loop,
            scaling_config=ScalingConfig(
                num_workers=3, use_gpu=False, worker_mode="threads",
                elastic=ElasticConfig(min_workers=1,
                                      grow_check_period_s=0.3)),
            datasets={"train": np.arange(1, 361, dtype=np.float64)},
            run_config=RunConfig(
                name="fusion", storage_path=str(tmp_path),
                checkpoint_config=CheckpointConfig(async_save=True,
                                                   replica_memory_steps=2),
                failure_config=FailureConfig(max_failures=3)))
        box = {}
        t = threading.Thread(
            target=lambda: box.update(result=trainer.fit()), daemon=True)
        t.start()
        deadline = time.time() + 20
        live = None
        while time.time() < deadline and live is None:
            rows = [r for r in state_api.list_train_runs(
                filters=[("status", "=", "running")])
                if r["name"] == "fusion"]
            if rows and rows[0]["world_size"] == 3 and \
                    rows[0].get("last_committed_step") is not None:
                live = rows[0]
            time.sleep(0.05)
        assert live is not None, "running row never appeared"
        assert live["elastic"] is True and live["target_world"] == 3
        assert simulate_preemption(str(nodes[0])) is not None
        time.sleep(1.0)
        cluster.add_node(num_cpus=1)
        t.join(timeout=90)
        assert not t.is_alive(), "fit() hung"
        r = box["result"]
        assert r.error is None, r.error
        kinds = [e["type"] for e in r.elastic_events]
        assert "shrink" in kinds, r.elastic_events
        row = state_api.get_train_run("fusion")
        assert row["status"] == "finished"
        assert row["last_committed_step"] is not None
        assert [e["type"] for e in row["events"]] == kinds
        out = tmp_path / "fusion_timeline.json"
        events = ray_tpu_torch.timeline(str(out))
        loaded = json.load(open(out))
        assert loaded and isinstance(loaded, list)
        for ev in loaded:
            assert ev["ph"] in ("X", "i")
            assert "pid" in ev and "tid" in ev and "ts" in ev
        train_lane = [ev for ev in events if ev.get("pid") == "train"]
        names = {ev["name"] for ev in train_lane}
        assert {"train.step", "train.data_wait", "train.elastic"} <= names, \
            sorted(names)
        assert any(n.startswith("checkpoint.") for n in names), sorted(names)
        steps = {ev["args"]["span_id"] for ev in train_lane
                 if ev["name"] == "train.step"}
        waits = [ev for ev in train_lane if ev["name"] == "train.data_wait"]
        assert waits and all(ev["args"]["parent_id"] in steps
                             for ev in waits)
        rec = next(ev for ev in train_lane if ev["name"] == "train.elastic")
        assert rec["args"]["from_world"] == 3 and rec["args"]["to_world"] == 2
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()
        run_registry.clear()
        ray_tpu_torch.shutdown()
