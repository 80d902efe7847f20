"""The port's flight recorder (ray_tpu_torch.util.flight_recorder) against
the reference's (ray_tpu.util.flight_recorder), on the cases of
tests/test_forensics.py's ``TestRing`` and ``TestDump``.

Each case runs on both packages with the same events and timestamps, and
what it observes must be equal: ring rows (sequence numbers, kinds, names,
times, status, detail), dump files' names and schema, flood-control
decisions, and what the ``forensics_dump`` fault point does. Both packages
write their postmortems into one temporary ``RAY_TPU_POSTMORTEM_DIR``, one
package at a time.
"""

import importlib
import json
import os
import tracemalloc
import types

import pytest

import ray_tpu.util.flight_recorder  # noqa: F401
import ray_tpu_torch.util.flight_recorder  # noqa: F401

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        name=name, fr=imp(f"{name}.util.flight_recorder"),
        tracing=imp(f"{name}.util.tracing"),
        config=imp(f"{name}._private.config"),
        faults=imp(f"{name}._private.fault_injection"))


def _reset(p):
    p.fr.reset_recorder()
    p.tracing.disable_tracing()
    p.tracing.clear_spans()


@pytest.fixture
def recorder_env(monkeypatch, tmp_path):
    """An isolated postmortem dir and fresh recorder singletons (the
    reference's hang watchdog, which the port has not, stays off)."""
    pm_dir = tmp_path / "postmortems"
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_DIR", str(pm_dir))
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_MIN_INTERVAL_S", "0")
    monkeypatch.setenv("RAY_TPU_HANG_WATCHDOG", "0")
    for name in PACKAGES:
        _reset(_pkg(name))
    yield pm_dir
    for name in PACKAGES:
        _reset(_pkg(name))


def _both(case):
    out = []
    for name in PACKAGES:
        p = _pkg(name)
        _reset(p)
        out.append(case(p))
    return out


def _set_chaos(p, spec: str) -> None:
    p.config.GLOBAL_CONFIG.testing_rpc_failure = spec
    p.faults.reset_injector()


# --------------------------------------------------------------------------
# Ring buffer
# --------------------------------------------------------------------------
def _wraparound(p):
    rec = p.fr.FlightRecorder(slots=16)
    for i in range(40):
        rec.record_event(f"e{i}", now=float(i))
    return rec.events_recorded(), rec.snapshot()


def _in_progress(p):
    rec = p.fr.FlightRecorder(slots=16)
    rec.record_event("ok", now=1.0)
    rec._ring[5][0] = -7  # a writer caught mid-fill: negative seq stamp
    return [r["name"] for r in rec.snapshot()]


def _span_tap(p):
    rec = p.fr.FlightRecorder()
    rec.tap_span({"name": "serve.request", "start": 1.0, "end": 2.5,
                  "status": "OK"})
    rec.tap_span({"name": "serve.route", "start": 3.0, "end": None,
                  "status": "OK"})
    return rec.snapshot()


def _live_tracing(p):
    rec = p.fr.get_recorder()
    p.tracing.enable_tracing()
    p.tracing.record_span("unit.span", 1.0, 2.0)
    return [(r["name"], r["start"], r["end"], r["status"])
            for r in rec.snapshot() if r["kind"] == "span"]


def _metric_deltas(p):
    rec = p.fr.FlightRecorder()
    rec.record_event("seed", now=1.0)  # bumps the ring-events counter
    first = rec.sample_metric_deltas(now=2.0) >= 1
    rows = [r for r in rec.snapshot() if r["kind"] == "metric"]
    moved = any(r["name"] == "ray_tpu_forensics_ring_events_total"
                and r["detail"] >= 1 for r in rows)
    rec.sample_metric_deltas(now=3.0)  # no movement since: no new rows
    after = [r for r in rec.snapshot() if r["kind"] == "metric"]
    return first, moved, len(after) == len(rows)


RING_CASES = {
    "wraparound_keeps_newest_and_counts_lifetime": (
        _wraparound, lambda out: out[0] == 40 and len(out[1]) == 16
        and [r["seq"] for r in out[1]] == list(range(24, 40))
        and out[1][0]["name"] == "e24" and out[1][-1]["name"] == "e39"),
    "snapshot_skips_in_progress_slots": (
        _in_progress, lambda out: out == ["ok"]),
    "span_tap_records_open_and_closed_spans": (
        _span_tap, lambda out: [r["kind"] for r in out] == ["span", "span"]
        and out[0]["end"] == 2.5 and out[1]["end"] == out[1]["start"] == 3.0),
    "singleton_taps_live_tracing": (
        _live_tracing, lambda out: ("unit.span", 1.0, 2.0, "OK") in out),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_matches_reference(recorder_env, name):
    case, check = RING_CASES[name]
    ref, port = _both(case)
    assert check(ref)
    assert port == ref


def test_sample_metric_deltas_records_counter_movement(recorder_env):
    ref, port = _both(_metric_deltas)
    assert ref == (True, True, True)
    assert port == ref


@pytest.mark.parametrize("pkg", PACKAGES)
def test_disabled_via_env(recorder_env, monkeypatch, pkg):
    p = _pkg(pkg)
    monkeypatch.setenv("RAY_TPU_FLIGHT_RECORDER", "0")
    p.fr.reset_recorder()
    assert p.fr.get_recorder() is None
    assert p.fr.trigger_dump("nope") is None
    p.fr.record_event("noop")  # must not raise


# --------------------------------------------------------------------------
# Postmortem dumps
# --------------------------------------------------------------------------
def _schema(p):
    rec = p.fr.FlightRecorder()
    rec.record_event("last_breath", {"rid": "r0"}, now=10.0)
    path = rec.dump("unit reason/x", extra={"a": 1})
    with open(path) as f:
        dump = json.load(f)
    os.remove(path)
    return dict(
        file=os.path.basename(path),
        fields={k: dump[k] for k in ("schema", "pid", "reason", "extra",
                                     "tracing_active")},
        has_heap="heap" in dump,
        events=dump["events_recorded"] >= 1,
        ring=[(r["kind"], r["name"], r["start"], r["detail"])
              for r in dump["ring"]],
        main_thread=any("MainThread" in n for n in dump["stacks"]),
        keys=sorted(dump))


def test_dump_schema_and_filename(recorder_env):
    ref, port = _both(_schema)
    assert ref["file"] == f"{os.getpid()}-unit_reason_x.json"
    assert ref["fields"] == {"schema": 1, "pid": os.getpid(),
                             "reason": "unit reason/x", "extra": {"a": 1},
                             "tracing_active": False}
    assert not ref["has_heap"] and ref["events"] and ref["main_thread"]
    assert ("event", "last_breath", 10.0, {"rid": "r0"}) in ref["ring"]
    assert port == ref


def _heap(p):
    rec = p.fr.FlightRecorder()
    was = tracemalloc.is_tracing()
    tracemalloc.start()
    try:
        path = rec.dump("traced")
        with open(path) as f:
            dump = json.load(f)
    finally:
        if not was:
            tracemalloc.stop()
    os.remove(path)
    return dump["tracing_active"], sorted(dump["heap"])


def test_heap_only_when_tracemalloc_already_tracing(recorder_env):
    ref, port = _both(_heap)
    assert ref[0] is True and ref[1]
    assert port == ref


def _flood(p):
    rec = p.fr.FlightRecorder()
    out = [rec.dump("crashloop", now=1000.0) is not None,
           rec.dump("crashloop", now=1001.0) is not None,  # suppressed
           rec.dump("other", now=1001.0) is not None,  # its own clock
           rec.dump("crashloop", now=1200.0) is not None]  # past the window
    for f in os.listdir(p.fr.postmortem_dir()):
        os.remove(os.path.join(p.fr.postmortem_dir(), f))
    return out


def test_flood_control_suppresses_repeats_per_reason(recorder_env,
                                                     monkeypatch):
    monkeypatch.setenv("RAY_TPU_POSTMORTEM_MIN_INTERVAL_S", "100")
    ref, port = _both(_flood)
    assert ref == [True, False, True, True]
    assert port == ref


def _fault_point(p):
    _set_chaos(p, "forensics_dump=1.0")
    try:
        rec = p.fr.FlightRecorder()
        with pytest.raises(p.faults.InjectedFailure):
            rec.dump("direct")  # the raw API surfaces chaos
        # trigger_dump absorbs: a forensics failure must never worsen the
        # failure being recorded.
        return p.fr.trigger_dump("absorbed")
    finally:
        _set_chaos(p, "")


def test_forensics_dump_fault_point_absorbed_by_trigger(recorder_env):
    ref, port = _both(_fault_point)
    assert ref is None
    assert port == ref


def _trigger(p):
    p.tracing.enable_tracing()
    path = p.fr.trigger_dump("unit_trigger", {"k": 1})
    with open(path) as f:
        dump = json.load(f)
    os.remove(path)
    trig = [(r["name"], r["detail"]) for r in dump["ring"]
            if r["kind"] == "trigger"]
    spans = [(s["name"], s["attributes"]["reason"])
             for s in p.tracing.exported_spans()
             if s["name"] == "forensics.dump"]
    return os.path.basename(path), trig[-1], spans


def test_trigger_dump_records_trigger_event_and_emits_span(recorder_env):
    ref, port = _both(_trigger)
    assert ref == (f"{os.getpid()}-unit_trigger.json",
                   ("unit_trigger", {"k": 1}),
                   [("forensics.dump", "unit_trigger")])
    assert port == ref
