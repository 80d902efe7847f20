"""The port's metrics agent (ray_tpu_torch._private.metrics_agent) and
time-series aggregator (ray_tpu_torch.util.metrics_agent) against the
reference's.

- ``test_metrics_agent_http_scrape`` of tests/test_observability.py, on
  each package in turn (never both runtimes at once): a task runs, and the
  agent's ``/metrics`` carries the runtime's gauges.
- The aggregator: both packages' aggregators get the same points (counter,
  value and gauge series, out-of-order arrivals, a counter reset, subset-tag
  rollups) and ``window_rate``, ``window_sum``, ``window_values`` and
  ``openmetrics_text`` must agree: rates within
  1e-12 relative, values and text exactly.
- The agent's other routes: what the port serves, and 404 for the
  reference's cluster and node pages, which need its nodes.
- ``test_timeline_chrome_export`` of tests/test_observability.py: a
  profiled task's chrome trace through ``timeline(filename)``.
"""

import importlib
import json
import random
import time
import tracemalloc
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import metrics_agent as ref_agg_mod
from ray_tpu_torch.util import metrics_agent as port_agg_mod

from _torch_runtimes import fresh_init, gc_paused

RATE_RTOL = 1e-12


def _scrape(pkg):
    fresh_init(pkg, num_cpus=4)
    try:
        @pkg.remote
        def work(x):
            return x + 1

        assert pkg.get(work.remote(1)) == 2
        agent_mod = importlib.import_module(
            f"{pkg.__name__}._private.metrics_agent")
        rt = importlib.import_module(f"{pkg.__name__}._private.runtime")
        agent = agent_mod.MetricsAgent(rt.get_runtime())
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{agent.port}/metrics",
                timeout=5).read().decode()
        finally:
            agent.stop()
        return ["ray_tpu_tasks_finished_total" in body,
                "ray_tpu_object_store_bytes" in body,
                "ray_tpu_nodes 1" in body]
    finally:
        pkg.shutdown()


def test_metrics_agent_http_scrape():
    with gc_paused():
        ref = _scrape(ray_tpu)
    port = _scrape(ray_tpu_torch)
    assert ref == [True, True, True]
    assert port == ref


# ---------------------------------------------------------- aggregator
def _points(seed=0):
    """(name, value, tags, kind, ts) in arrival order: counters with a
    reset, per-event values, gauges, two tag-sets a name, late points."""
    rng = random.Random(seed)
    out = []
    totals = {}
    for i in range(400):
        ts = 1000.0 + i * 0.25 + (rng.uniform(-0.6, 0.0) if i % 7 == 0
                                  else 0.0)
        for dep in ("a#D", "b#E"):
            tags = {"deployment": dep}
            if i == 250 and dep == "a#D":
                totals[dep] = 0.0  # a process restart: the total falls
            totals[dep] = totals.get(dep, 0.0) + rng.randint(0, 5)
            out.append(("reqs_total", totals[dep], tags, "counter", ts))
            out.append(("latency_s", rng.expovariate(20.0),
                        {**tags, "pool": "mono"}, "value", ts))
            out.append(("occupancy", rng.random(), {"pool": dep[0]},
                        "gauge", ts))
    return out


QUERIES = [
    ("reqs_total", {"deployment": "a#D"}), ("reqs_total", None),
    ("latency_s", {"deployment": "b#E"}), ("latency_s", None),
    ("occupancy", {"pool": "a"}), ("occupancy", None),
    ("missing", None),
]


def _aggregate(mod):
    agg = mod.TimeSeriesAggregator(max_window_s=60.0)
    for name, value, tags, kind, ts in _points():
        agg.observe(name, value, tags, kind=kind, ts=ts)
    now = 1100.0
    out = {"rates": [], "sums": [], "values": []}
    for name, tags in QUERIES:
        for w in (1.0, 5.0, 30.0, 120.0):
            out["rates"].append(agg.window_rate(name, tags, w, now))
            out["sums"].append(agg.window_sum(name, tags, w, now))
            out["values"].append(agg.window_values(name, tags, w, now))
    out["text"] = agg.openmetrics_text(windows=(5.0, 30.0), now=now)
    out["names"] = agg.series_names()
    return out


def test_aggregator_matches_reference_on_the_same_points():
    ref = _aggregate(ref_agg_mod)
    port = _aggregate(port_agg_mod)
    assert any(r > 0 for r in ref["rates"])
    for key in ("rates", "sums"):
        assert port[key] == pytest.approx(ref[key], rel=RATE_RTOL, abs=0.0)
    for key in ("values", "text", "names"):
        assert port[key] == ref[key]


def test_collector_merges_sources_like_reference():
    """Two nodes' snapshots through each package's TimeSeriesCollector: a
    cluster rate sums the per-node rates."""
    out = []
    for mod in (ref_agg_mod, port_agg_mod):
        col = mod.TimeSeriesCollector(max_window_s=60.0)
        for node, scale in (("n1", 1.0), ("n2", 3.0)):
            agg = mod.TimeSeriesAggregator()
            for i in range(20):
                agg.observe("reqs_total", i * scale, {"deployment": "a#D"},
                            kind="counter", ts=100.0 + i)
            col.push(agg.snapshot(since=105.0), source=node)
        out.append((col.window_rate("reqs_total", None, 10.0, 120.0),
                    col.window_rate("reqs_total", {"node": "n2"}, 10.0,
                                    120.0),
                    col.series_names(),
                    col.openmetrics_text(windows=(10.0,), now=120.0)))
    assert out[0][0] == pytest.approx(4.0 * 10 / 10.0)
    assert out[1] == out[0]


# --------------------------------------------------------- other routes
def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_port_agent_routes():
    from ray_tpu_torch._private.metrics_agent import MetricsAgent
    from ray_tpu_torch._private.runtime import get_runtime

    fresh_init(ray_tpu_torch, num_cpus=2)
    agent = MetricsAgent(get_runtime())
    tracing = tracemalloc.is_tracing()
    try:
        status, ctype, body = _get(agent.port, "/timeseries")
        assert status == 200 and ctype.startswith("application/openmetrics")
        assert body.decode().endswith("# EOF\n")
        status, _, body = _get(agent.port, "/api/serve")
        assert status == 200
        assert json.loads(body) == {"applications": [], "num_deployments": 0,
                                    "num_replicas": 0, "deployments": [],
                                    "replicas": []}
        status, _, body = _get(agent.port, "/api/stacks")
        assert status == 200
        assert any("MainThread" in n for n in json.loads(body)["driver"])
        status, _, body = _get(agent.port, "/api/memory")
        assert status == 200 and "traced_current_bytes" in json.loads(body)
        # The state API's, the jobs' and the postmortems' routes answer
        # (tests/test_torch_state.py holds their rows to the reference's);
        # the reference's cluster and node pages, which need its nodes, and
        # a postmortem id with no dump do not.
        for path in ("/api/tasks", "/api/actors", "/api/objects",
                     "/api/nodes", "/api/placement_groups", "/api/jobs",
                     "/api/postmortems", "/api/postmortems/bundle"):
            status, ctype, _ = _get(agent.port, path)
            assert (status, ctype) == (200, "application/json"), path
        for path in ("/api", "/api/cluster", "/api/node/x",
                     "/api/postmortems/no-such-dump", "/", "/nope"):
            assert _get(agent.port, path)[0] == 404, path
    finally:
        agent.stop()
        ray_tpu_torch.shutdown()
        if not tracing:  # /api/memory starts tracemalloc
            tracemalloc.stop()


# ------------------------------------------------------------- timeline
def _timeline(pkg, path):
    fresh_init(pkg, num_cpus=4)
    try:
        @pkg.remote
        def traced():
            time.sleep(0.01)
            return 1

        pkg.get(traced.remote())
        events = pkg.timeline(str(path))
        data = json.loads(path.read_text())
        span = next(e for e in data if e["cat"] == "task")
        return [data == events, sorted({e["cat"] for e in data}),
                span["name"], span["dur"] >= 10_000 * 0.5,
                sorted((e["cat"], e["ph"], e["name"])
                       for e in data)]
    finally:
        pkg.shutdown()


def test_timeline_chrome_export(tmp_path):
    """tests/test_observability.py's timeline case: a task, then
    ``timeline(filename)``, on each package in turn."""
    with gc_paused():
        ref = _timeline(ray_tpu, tmp_path / "ref.json")
    port = _timeline(ray_tpu_torch, tmp_path / "port.json")
    assert ref[:4] == [True, ["sched", "task"], "traced", True]
    assert port == ref
