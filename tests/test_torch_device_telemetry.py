"""The port's device-telemetry plane (ray_tpu_torch.util.device_telemetry)
and its taps, on the CPU; the counterpart of tests/test_device_telemetry.py.

Bottom-up, as the reference's file: trigger classification and the compile
registry; the recompile-storm detector (threshold, window expiry,
drain/re-arm) and a storm's ring event, postmortem and fused timeline; the
pools (add/sub/peak/floor, ``pool_set``, ``tree_nbytes`` over fp32 and bf16
tensors and numpy) and the ``mux_weights`` hook of the port's multiplex;
the transfer ledger, windowed ``transfer_bw``, the prefetcher's h2d hook
and the checkpoint snapshot's d2h hook with ``ckpt_staging`` back at 0;
the compile taps (``_private/torch_compat.py``'s ``instrumented_step`` on
real functions and on a tiny GPT-2 step, ``kernel_build``'s nvcc runs
through a stand-in compiler); the snapshot, the forensics bundle and the
fault point, ``publish``, the serve accessor and status block, the
Perfetto device lane. Then one parity case: the same calls into
``ray_tpu.util.device_telemetry`` and the port give equal records,
triggers, storm decisions and pools.
"""

import asyncio
import json
import os
import stat
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.util import device_telemetry as dt
from ray_tpu_torch.util import flight_recorder, forensics, tracing, watchdog


def _set_chaos(spec: str) -> None:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.fault_injection import reset_injector

    GLOBAL_CONFIG.testing_rpc_failure = spec
    reset_injector()


@pytest.fixture(autouse=True)
def clean_telemetry():
    dt.reset()
    yield
    dt.reset()


@pytest.fixture
def recorder_env(monkeypatch, tmp_path):
    """Isolated postmortem dir + fresh recorder/watchdog singletons."""
    pm_dir = tmp_path / "postmortems"
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(pm_dir))
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_MIN_INTERVAL_S", "0")
    monkeypatch.setenv("RAY_TPU_HANG_WATCHDOG", "0")
    flight_recorder.reset_recorder()
    watchdog.reset_watchdog()
    yield pm_dir
    flight_recorder.reset_recorder()
    watchdog.reset_watchdog()
    tracing.disable_tracing()
    tracing.clear_spans()


# --------------------------------------------------------------------------
# Compile-trigger classification
# --------------------------------------------------------------------------
class TestTriggerClassification:
    def test_precedence_sequence(self):
        assert dt.record_compile("f", shapes=("a",), shardings=("s1",),
                                 donation=(0,)) == dt.TRIGGER_FIRST
        assert dt.record_compile("f", shapes=("b",), shardings=("s1",),
                                 donation=(0,)) == dt.TRIGGER_SHAPE
        assert dt.record_compile("f", shapes=("b",), shardings=("s2",),
                                 donation=(0,)) == dt.TRIGGER_SHARDING
        assert dt.record_compile("f", shapes=("b",), shardings=("s2",),
                                 donation=(0, 1)) == dt.TRIGGER_DONATION
        assert dt.record_compile("f", shapes=("b",), shardings=("s2",),
                                 donation=(0, 1)) == dt.TRIGGER_RECOMPILE

    def test_labels_classify_independently(self):
        dt.record_compile("f", shapes=("a",))
        assert dt.record_compile("g", shapes=("a",)) == dt.TRIGGER_FIRST

    def test_registry_tail_and_totals(self):
        dt.record_compile("f", shapes=("a",), trace_s=0.5, compile_s=1.0)
        dt.record_compile("f", shapes=("b",), trace_s=0.25, compile_s=0.25)
        dt.record_compile("g", shapes=("a",))
        rows = dt.compile_records("f")
        assert [r["trigger"] for r in rows] == [dt.TRIGGER_FIRST,
                                                dt.TRIGGER_SHAPE]
        assert all(r["label"] == "f" for r in rows)
        totals = dt.compile_totals()
        assert totals["compiles"] == 3
        assert totals["by_trigger"] == {dt.TRIGGER_FIRST: 2,
                                        dt.TRIGGER_SHAPE: 1}
        assert totals["compile_seconds"] == pytest.approx(2.0)

    def test_classify_trigger_is_read_only(self):
        dt.record_compile("f", shapes=("a",))
        assert dt.classify_trigger("f", ("b",), None, ()) == dt.TRIGGER_SHAPE
        assert dt.classify_trigger("f", ("b",), None, ()) == dt.TRIGGER_SHAPE


# --------------------------------------------------------------------------
# Recompile-storm detector
# --------------------------------------------------------------------------
class TestStormDetector:
    def test_threshold_drain_and_rearm(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_COMPILE_STORM_THRESHOLD", "2")
        monkeypatch.setenv("RAY_TPU_COMPILE_STORM_WINDOW_S", "60")
        dt.record_compile("f", shapes=("a",), ts=1.0)  # first: not counted
        dt.record_compile("f", shapes=("b",), ts=2.0)
        assert dt.compile_totals()["storms"] == 0
        dt.record_compile("f", shapes=("a",), ts=3.0)
        assert dt.compile_totals()["storms"] == 1
        # Firing drained the window: one more recompile is below threshold,
        # the next one re-trips.
        dt.record_compile("f", shapes=("b",), ts=4.0)
        assert dt.compile_totals()["storms"] == 1
        dt.record_compile("f", shapes=("a",), ts=5.0)
        assert dt.compile_totals()["storms"] == 2

    def test_window_expiry(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_COMPILE_STORM_THRESHOLD", "2")
        monkeypatch.setenv("RAY_TPU_COMPILE_STORM_WINDOW_S", "60")
        dt.record_compile("f", shapes=("a",), ts=0.0)
        dt.record_compile("f", shapes=("b",), ts=1.0)
        dt.record_compile("f", shapes=("a",), ts=100.0)
        assert dt.compile_totals()["storms"] == 0

    def test_watchdog_tick_drives_the_detector(self, recorder_env,
                                               monkeypatch):
        """The hang watchdog's tick probes this module and runs a storm
        pass: recompiles recorded with old timestamps expire there."""
        monkeypatch.setenv("RAY_TPU_COMPILE_STORM_THRESHOLD", "5")
        dt.record_compile("f", shapes=("a",), ts=1.0)
        dt.record_compile("f", shapes=("b",), ts=2.0)
        watchdog.get_watchdog().tick()
        assert len(dt._recompile_ts) == 0  # aged out of the window

    def test_storm_chaos_postmortem_and_fused_timeline(self, recorder_env,
                                                       monkeypatch):
        """A recompile storm leaves an ERROR ring event, a postmortem dump
        whose fused Perfetto timeline carries ``storm:xla.compile_storm``,
        and a bundle embedding the device-telemetry snapshot."""
        monkeypatch.setenv("RAY_TPU_COMPILE_STORM_THRESHOLD", "3")
        shapes = [("a",), ("b",)]
        for i in range(4):  # first compile + 3 shape-change recompiles
            dt.record_compile("storm_fn", shapes=shapes[i % 2])
        assert dt.compile_totals()["storms"] == 1

        rec = flight_recorder.get_recorder()
        assert rec is not None
        storm_rows = [r for r in rec.snapshot() if r["kind"] == "storm"]
        assert storm_rows and storm_rows[0]["name"] == "xla.compile_storm"
        assert storm_rows[0]["status"] == "ERROR"

        rows = [r for r in forensics.list_postmortems()
                if "compile_storm" in str(r.get("reason"))]
        assert rows, "storm did not trigger a postmortem dump"
        dump = forensics.load_postmortem(rows[0]["id"])
        assert dump["extra"]["recompiles"] >= 3

        bundle = forensics.build_bundle()
        snap = bundle["device_telemetry"]
        assert snap is not None
        assert snap["compiles"]["totals"]["storms"] == 1
        assert snap["compiles"]["totals"]["by_trigger"][dt.TRIGGER_SHAPE] == 3

        names = {e["name"] for e in forensics.bundle_chrome_trace(bundle)}
        assert "storm:xla.compile_storm" in names
        assert "dump:compile_storm" in names


# --------------------------------------------------------------------------
# Device-memory pools
# --------------------------------------------------------------------------
class TestPools:
    def test_add_sub_peak_and_floor(self):
        dt.pool_add("p", 100)
        dt.pool_add("p", 50)
        dt.pool_sub("p", 120)
        assert dt.pool_bytes()["p"] == {"bytes": 30.0, "peak": 150.0}
        dt.pool_sub("p", 1000)
        assert dt.pool_bytes()["p"]["bytes"] == 0.0
        assert dt.pool_bytes()["p"]["peak"] == 150.0
        assert dt.POOL_BYTES.get({"pool": "p"}) == 0.0
        assert dt.POOL_PEAK_BYTES.get({"pool": "p"}) == 150.0

    def test_pool_set_absolute(self):
        dt.pool_add("q", 10)
        dt.pool_set("q", 500)
        dt.pool_set("q", 200)
        assert dt.pool_bytes()["q"] == {"bytes": 200.0, "peak": 500.0}

    def test_tree_nbytes(self):
        tree = {"a": np.zeros((4, 4), np.float32),
                "b": [np.zeros(8, np.int64), "not-an-array"],
                "c": (np.zeros(0, np.float32),),
                "t32": torch.zeros(3, 5),
                "t16": [torch.zeros(7, dtype=torch.bfloat16)],
                "view": torch.zeros(10, 10)[:, :3]}
        assert dt.tree_nbytes(tree) == (4 * 4 * 4 + 8 * 8 + 3 * 5 * 4
                                        + 7 * 2 + 10 * 3 * 4)
        assert dt.tree_nbytes("just a string") == 0

    def test_mux_weights_hook_in_multiplex(self):
        """A multiplexed loader's weights are charged to ``mux_weights`` at
        load and released at eviction, exactly."""
        from ray_tpu_torch.serve.multiplex import multiplexed

        sizes = {"a": 100, "b": 30}

        @multiplexed(max_num_models_per_replica=1)
        async def load(model_id):
            return {"w": torch.zeros(sizes[model_id]),
                    "b": np.zeros(4, np.float32)}

        async def drive():
            await load("a")
            seen = [dt.pool_bytes()["mux_weights"]["bytes"]]
            await load("b")  # evicts "a"
            seen.append(dt.pool_bytes()["mux_weights"]["bytes"])
            for wrapper in load._multiplex_wrappers.values():
                await wrapper.unload_all()
            seen.append(dt.pool_bytes()["mux_weights"]["bytes"])
            return seen

        assert asyncio.run(drive()) == [416.0, 136.0, 0.0]
        assert dt.pool_bytes()["mux_weights"]["peak"] == 416.0


# --------------------------------------------------------------------------
# Transfer ledger
# --------------------------------------------------------------------------
class TestTransfers:
    def test_ledger_tail(self):
        dt.record_transfer("h2d", 1000, src="unit_a")
        dt.record_transfer("d2h", 500, src="unit_b")
        rows = dt.transfer_records()
        assert [(r["direction"], r["bytes"], r["src"]) for r in rows] == \
            [("h2d", 1000, "unit_a"), ("d2h", 500, "unit_b")]

    def test_windowed_bandwidth(self):
        t0 = time.time()
        dt.record_transfer("h2d", 1, src="bw_unit")
        dt.transfer_bw("h2d", src="bw_unit", now=t0)  # baseline sample
        dt.record_transfer("h2d", 5999, src="bw_unit")
        bw = dt.transfer_bw("h2d", src="bw_unit", window_s=60.0,
                            now=t0 + 1.0)
        assert bw == pytest.approx(5999 / 60.0, rel=0.01)
        assert dt.transfer_bw("d2h", src="bw_unit", now=t0 + 1.0) == 0.0

    def test_prefetcher_h2d_hook(self):
        """``DeviceBatchIterator`` ledgers each batch's numeric columns as
        one h2d transfer (``ingest_prefetch``); strings stay on the host."""
        from ray_tpu_torch.data.ingest.prefetch import DeviceBatchIterator

        batches = [{"tokens": np.zeros((2, 8), np.int32),
                    "w": np.ones(3, np.float64), "labels": ["a", "b"]}
                   for _ in range(3)]
        out = list(DeviceBatchIterator(iter(batches), device="cpu"))
        assert [b["labels"] for b in out] == [["a", "b"]] * 3
        rows = [r for r in dt.transfer_records()
                if r["src"] == "ingest_prefetch"]
        assert [(r["direction"], r["bytes"]) for r in rows] == \
            [("h2d", 2 * 8 * 4 + 3 * 8)] * 3

    @pytest.mark.parametrize("mode", ["async", "sync"])
    def test_checkpoint_snapshot_d2h_hook(self, tmp_path, mode):
        """A save's snapshot is one d2h transfer (``ckpt_snapshot``) of the
        state's bytes, staged in ``ckpt_staging`` until its persist."""
        from ray_tpu_torch.checkpoint import CheckpointCoordinator, ShardWriter

        state = {"w": torch.randn(64, 32), "m": torch.zeros(
            16, dtype=torch.bfloat16), "step": 3}
        nbytes = 64 * 32 * 4 + 16 * 2
        coord = CheckpointCoordinator(str(tmp_path), keep=2,
                                      replicate_to_peer=False)
        writer = ShardWriter(coord, replicate=False)
        try:
            if mode == "async":
                handle = writer.save_async(0, state)
                handle.result(timeout=60)
            else:
                writer.save_sync(0, state)
        finally:
            writer.close()
        rows = [r for r in dt.transfer_records()
                if r["src"] == "ckpt_snapshot"]
        assert [(r["direction"], r["bytes"]) for r in rows] == \
            [("d2h", nbytes)]
        assert dt.pool_bytes()["ckpt_staging"] == {"bytes": 0.0,
                                                   "peak": float(nbytes)}


# --------------------------------------------------------------------------
# The compile taps
# --------------------------------------------------------------------------
class TestInstrumentedStep:
    def test_first_call_then_shape_change(self):
        from ray_tpu_torch._private import torch_compat

        step = torch_compat.instrumented_step(lambda x: x * 2 + 1,
                                              label="unit_fn")
        x3 = torch.arange(3, dtype=torch.float32)
        np.testing.assert_allclose(step(x3).numpy(), [1.0, 3.0, 5.0])
        step(x3)  # a seen signature: no new record
        rows = dt.compile_records("unit_fn")
        assert [r["trigger"] for r in rows] == [dt.TRIGGER_FIRST]
        assert rows[0]["compile_s"] >= 0 and rows[0]["trace_s"] == 0
        step(torch.arange(4, dtype=torch.float32))
        assert [r["trigger"] for r in dt.compile_records("unit_fn")] == \
            [dt.TRIGGER_FIRST, dt.TRIGGER_SHAPE]
        step(torch.arange(4, dtype=torch.float64))  # dtype is the shape's
        assert len(step._cache) == 3

    def test_python_scalars_do_not_recompile(self):
        from ray_tpu_torch._private import torch_compat

        step = torch_compat.instrumented_step(lambda x, s: x * s,
                                              label="unit_scalar")
        x = torch.ones(4)
        step(x, 2.0)
        step(x, 3.0)  # same abstract signature
        assert len(dt.compile_records("unit_scalar")) == 1
        step(x, 3)  # an int is another type
        assert [r["trigger"] for r in dt.compile_records("unit_scalar")] \
            == [dt.TRIGGER_FIRST, dt.TRIGGER_SHAPE]

    def test_gpt2_train_step_compiles_once(self):
        """GPT-2 tiny through ``optim.make_step`` (``make_train_step``),
        two steps: exactly one first_compile, no recompile."""
        from ray_tpu_torch._private import torch_compat
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.optim import make_optimizer

        cfg = gpt2.GPTConfig.tiny()
        params = gpt2.init_params(cfg, seed=0, device="cpu")
        optimizer = make_optimizer(3e-4)
        opt_state = optimizer.init(params)
        step = torch_compat.instrumented_step(
            gpt2.make_train_step(cfg, optimizer), label="gpt2_step")
        tok = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, cfg.seq_len + 1)))
        losses = []
        for _ in range(2):
            params, opt_state, loss = step(params, opt_state, tok[:, :-1],
                                           tok[:, 1:])
            losses.append(float(loss))
        assert all(np.isfinite(losses))
        totals = dt.compile_totals()
        assert totals["compiles"] == 1
        assert totals["by_trigger"] == {dt.TRIGGER_FIRST: 1}
        assert dt.compile_records()[0]["label"] == "gpt2_step"

    def test_kernel_build_records_each_nvcc_run(self, tmp_path, monkeypatch):
        """Each nvcc run of ``kernel_build.build`` is one ``kernel:<name>``
        compile with the build digest as its signature; a second build
        loads the existing libraries and records none. A stand-in
        compiler (it writes its ``-o`` file) takes nvcc's place."""
        from ray_tpu_torch._private import kernel_build

        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for name in ("alpha", "beta"):
            (csrc / f"{name}.cu").write_text(f"// {name}\n")
        fake = tmp_path / "bin" / "nvcc"
        fake.parent.mkdir()
        fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                        "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                        "  shift\ndone\necho ptxas info\n")
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(kernel_build, "CSRC_DIR", csrc)
        monkeypatch.setattr(kernel_build, "BUILD_ROOT", tmp_path / "_build")
        monkeypatch.setattr(kernel_build, "find_nvcc", lambda: str(fake))
        runs = kernel_build.NVCC_RUNS
        libs = kernel_build.build()
        assert sorted(libs) == ["alpha", "beta"]
        assert kernel_build.NVCC_RUNS == runs + 2
        rows = dt.compile_records()
        digest = kernel_build.build_dir().name
        assert sorted(r["label"] for r in rows) == ["kernel:alpha",
                                                    "kernel:beta"]
        assert all(r["trigger"] == dt.TRIGGER_FIRST and r["compile_s"] > 0
                   and r["signature"] == repr(digest) for r in rows)
        kernel_build.build()  # built already: loads, compiles nothing
        assert len(dt.compile_records()) == 2
        assert kernel_build.NVCC_RUNS == runs + 2


# --------------------------------------------------------------------------
# Snapshot, bundle embedding, fault absorption, rollup
# --------------------------------------------------------------------------
class TestSnapshotAndRollup:
    def test_snapshot_is_json_serializable(self):
        dt.record_compile("f", shapes=("a",))
        dt.pool_add("kv_blocks", 100)
        dt.record_transfer("h2d", 10, src="unit")
        doc = json.loads(json.dumps(dt.snapshot()))
        assert set(doc) == {"ts", "compiles", "pools", "transfers",
                            "device_memory"}
        assert doc["compiles"]["totals"]["compiles"] == 1
        assert doc["pools"]["kv_blocks"]["bytes"] == 100
        assert doc["transfers"]["tail"][-1]["bytes"] == 10
        assert set(doc["transfers"]) == {"tail", "window_s", "bytes_per_s"}
        # No CUDA device here: no memory rows, as the reference's CPU
        # backend gives none.
        if not torch.cuda.is_available():
            assert doc["device_memory"] == []

    def test_bundle_absorbs_snapshot_fault(self, recorder_env):
        """The device_telemetry_snapshot chaos point costs the bundle only
        its device section, never the ring/timeseries."""
        _set_chaos("device_telemetry_snapshot=1:1")
        try:
            bundle = forensics.build_bundle()
            assert bundle["device_telemetry"] is None
            assert "timeseries" in bundle and "dumps" in bundle
            assert forensics.build_bundle()["device_telemetry"] is not None
        finally:
            _set_chaos("")

    def test_publish_rolls_up_to_collector(self):
        from ray_tpu_torch.util.metrics_agent import TimeSeriesCollector

        dt.record_compile("f", shapes=("a",), trace_s=0.1, compile_s=0.2)
        dt.record_transfer("h2d", 100, src="pub_unit")
        collector = TimeSeriesCollector()
        dt.publish(collector, source="nodeA")
        names = collector.series_names()
        assert "ray_tpu_xla_compiles_total" in names
        assert "ray_tpu_device_transfer_bytes_total" in names

    def test_serve_accessor_resolves(self):
        from ray_tpu_torch import serve

        assert serve.device.transfer_bw is dt.transfer_bw
        assert "device" in serve.__all__


# --------------------------------------------------------------------------
# Perfetto "device" lane
# --------------------------------------------------------------------------
class TestDeviceLane:
    def test_device_plane_spans_share_the_device_pid(self):
        from ray_tpu_torch._private.profiling import spans_to_chrome_events

        tracing.clear_spans()
        tracing.enable_tracing()
        try:
            t = time.time()
            dt.record_compile("f", shapes=("a",), trace_s=0.1, compile_s=0.2,
                              ts=t)
            dt.record_transfer("h2d", 64, src="unit", start=t - 0.5, end=t)
            dt.record_burn("train_step", t - 0.2, t)
            spans = tracing.exported_spans()
        finally:
            tracing.disable_tracing()
            tracing.clear_spans()
        events = {e["name"]: e for e in spans_to_chrome_events(spans)}
        for name in ("xla.compile", "device.transfer", "device.burn"):
            assert events[name]["pid"] == "device"
        assert events["device.transfer"]["args"]["bytes"] == 64

    def test_burn_is_noop_when_tracing_disabled(self):
        tracing.clear_spans()
        dt.record_burn("train_step", 1.0, 2.0)
        assert tracing.exported_spans() == []


# --------------------------------------------------------------------------
# Parity with the reference
# --------------------------------------------------------------------------
def _drive(mod):
    """One sequence of compiles (a storm at threshold 3 among them), pool
    changes and transfers; what the module observed, timestamps aside."""
    mod.reset()
    triggers = []
    storms = []
    shapes = [("a",), ("b",), ("b",), ("c",), ("a",), ("a",)]
    for i, s in enumerate(shapes):
        triggers.append(mod.record_compile(
            "f" if i % 3 else "g", shapes=s, shardings=("d0",),
            donation=(i % 2,), trace_s=0.01 * i, compile_s=0.5, ts=10.0 + i))
        storms.append(mod.compile_totals()["storms"])
    storms.append(mod.storm_tick(now=100.0))
    mod.pool_add("mux_weights", 400)
    mod.pool_add("ckpt_staging", 120)
    mod.pool_sub("mux_weights", 150)
    mod.pool_set("kv_blocks", 77)
    mod.pool_sub("ckpt_staging", 500)
    mod.record_transfer("h2d", 4096, src="ingest_prefetch")
    mod.record_transfer("d2h", 1234.0, src="ckpt_snapshot", start=1.0,
                        end=2.0)
    records = [{k: v for k, v in r.items() if k != "ts"}
               for r in mod.compile_records()]
    transfers = [{k: v for k, v in r.items() if k != "ts"}
                 for r in mod.transfer_records()]
    out = (triggers, storms, records, mod.compile_totals(), mod.pool_bytes(),
           transfers, mod.classify_trigger("f", ("a",), ("d0",), (1,)))
    mod.reset()
    return out


def test_the_same_calls_give_what_the_reference_gives(recorder_env,
                                                      monkeypatch):
    from ray_tpu.util import device_telemetry as jdt
    from ray_tpu.util import flight_recorder as jfr

    monkeypatch.setenv("RAY_TPU_COMPILE_STORM_THRESHOLD", "3")
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(recorder_env / "ref"))
    jfr.reset_recorder()
    try:
        want = _drive(jdt)
    finally:
        jfr.reset_recorder()
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(recorder_env / "port"))
    got = _drive(dt)
    assert got == want
    assert want[0].count(dt.TRIGGER_FIRST) == 2 and max(want[1]) >= 1
    assert os.listdir(recorder_env / "ref") and os.listdir(recorder_env / "port")
