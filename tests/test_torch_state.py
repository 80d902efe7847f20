"""The port's state API (``ray_tpu_torch.util.state``), pub/sub
(``util.pubsub``), crash forensics (``util.forensics``) and the metrics
agent's state, job and postmortem routes against the reference's: the cases
of tests/test_observability.py (:85, :132, :301), tests/test_control_plane.py
(:90-150) and tests/test_forensics.py (:370-440) on both packages.

A case that needs a runtime runs on the reference, then on the port, each in
a runtime of its own (tests/_torch_train_parity.py); one that needs none
runs on each package in turn. The observations (filtered rows, summaries,
sequence numbers, dump indexes, timeline events) must be equal.
"""

import contextlib
import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both, observe, raises


def _sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _parity(case, *args):
    ref, port = both(case, *args)
    assert_same(ref, port, atol=0)
    return port


def _each(case, *args):
    out = [observe(case(pkg, *args)) for pkg in (ray_tpu, ray_tpu_torch)]
    assert_same(out[0], out[1], atol=0)
    return out[1]


# --------------------------------------------- tests/test_observability.py:85
def _tasks_actors_objects_nodes(pkg):
    st = _sub(pkg, "util.state")

    @pkg.remote
    def ok():
        return 1

    @pkg.remote
    def boom():
        raise ValueError("nope")

    pkg.get(ok.remote())
    obs = {"boom_raises": raises(lambda: pkg.get(boom.remote())) is not None}
    by_name = {t["name"]: t for t in st.list_tasks()}
    obs["states"] = {k: by_name[k]["state"] for k in ("ok", "boom")}
    obs["error_has_type"] = "ValueError" in by_name["boom"]["error_type"]
    obs["row_keys"] = sorted(by_name["ok"])
    obs["failed"] = sorted(t["name"] for t in st.list_tasks(
        filters=[("state", "=", "FAILED")]))
    obs["not_failed"] = sorted(t["name"] for t in st.list_tasks(
        filters=[("state", "!=", "FAILED")]))
    obs["limit"] = len(st.list_tasks(limit=1))
    obs["bad_op"] = raises(lambda: st.list_tasks(filters=[("state", ">",
                                                           "x")]))
    obs["summary"] = st.summarize_tasks()
    tid = by_name["ok"]["task_id"]
    obs["get_task"] = st.get_task(tid)["name"], st.get_task("nope")

    @pkg.remote
    class Holder:
        def ping(self):
            return "pong"

    h = Holder.remote()
    obs["pong"] = pkg.get(h.ping.remote())
    actors = st.list_actors(filters=[("class_name", "=", "Holder")])
    obs["actors"] = [(a["class_name"], a["state"], a["name"],
                      a["num_restarts"]) for a in actors]
    obs["actor_summary"] = st.summarize_actors()
    obs["get_actor"] = st.get_actor(actors[0]["actor_id"])["state"]
    obs["get_actor_none"] = st.get_actor("nope")
    pkg.kill(h)
    time.sleep(0.2)
    obs["after_kill"] = [a["state"] for a in st.list_actors(
        filters=[("class_name", "=", "Holder")])]

    ref = pkg.put(b"x" * 1024)
    objs = st.list_objects()
    obs["object_listed"] = any(o["object_id"] == str(ref.id) for o in objs)
    obs["objects_ready"] = st.summarize_objects()["by_state"].get(
        "READY", 0) >= 1
    nodes = st.list_nodes()
    obs["nodes"] = [(n["alive"], n["resources"]["CPU"], n["labels"],
                     sorted(n)) for n in nodes]
    obs["nodes_filtered"] = len(st.list_nodes(filters=[("alive", "=",
                                                         "False")]))
    obs["deployments"] = (st.list_deployments(), st.list_replicas())
    return obs


def test_state_api_tasks_actors_objects_nodes():
    obs = _parity(_tasks_actors_objects_nodes)
    assert obs["states"] == {"ok": "FINISHED", "boom": "FAILED"}
    assert obs["failed"] == ["boom"] and obs["not_failed"] == ["ok"]
    assert obs["summary"]["by_func"]["ok"]["FINISHED"] == 1
    assert obs["actor_summary"]["by_class"]["Holder"]["ALIVE"] == 1
    assert obs["after_kill"] == ["DEAD"]
    assert obs["nodes"][0][:2] == [True, 4.0]


# -------------------------------------------- tests/test_observability.py:132
def _placement_groups(pkg):
    st = _sub(pkg, "util.state")
    placement_group = _sub(pkg, "util.placement_group").placement_group
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK",
                         name="pair")
    pkg.get(pg.ready())
    rows = [r for r in st.list_placement_groups()
            if r["placement_group_id"] == str(pg.id)]
    return [(r["name"], r["state"], r["strategy"], r["bundles"])
            for r in rows]


def test_state_api_placement_groups():
    assert _parity(_placement_groups) == [
        ["pair", "CREATED", "PACK", [{"CPU": 1.0}, {"CPU": 1.0}]]]


def _no_runtime(pkg):
    st = _sub(pkg, "util.state")
    pkg.shutdown()
    return [raises(st.list_tasks), raises(st.list_actors)]


def test_state_api_needs_a_runtime():
    assert _each(_no_runtime) == ["RuntimeError", "RuntimeError"]


# ------------------------------------------------------- train runs by name
def _train_runs(pkg, pm_dir):
    """The state API and the bundle find the package's own run registry by
    its module name (a string: no import scan sees it)."""
    registry = _sub(pkg, "train.run_registry")
    st = _sub(pkg, "util.state")
    registry.clear()
    registry.register_run("wf-run", world_size=1, target_world=2)
    registry.finish_run("wf-run", "finished")
    with _postmortem_dir(pkg, pm_dir):
        bundle = _sub(pkg, "util.forensics").build_bundle()
    runs = st.list_train_runs(filters=[("status", "=", "finished")])
    out = ([(r["name"], r["world_size"], r["target_world"]) for r in runs],
           st.get_train_run("wf-run")["status"], st.get_train_run("nope"),
           [r["name"] for r in bundle["train_runs"]],
           bundle["device_telemetry"] is not None)
    registry.clear()
    return out


def test_train_runs_in_listing_and_bundle(tmp_path):
    ref, port = (_train_runs(pkg, str(tmp_path / pkg.__name__))
                 for pkg in (ray_tpu, ray_tpu_torch))
    assert port == ([("wf-run", 1, 2)], "finished", None, ["wf-run"], True)
    assert ref == port


# ----------------------------------------- tests/test_control_plane.py:90-150
def _long_poll(pkg):
    pub = _sub(pkg, "util.pubsub").Publisher()
    got = []

    def poller():
        got.extend(pub.poll("ch", after_seq=0, timeout=5))

    t = threading.Thread(target=poller)
    t.start()
    time.sleep(0.1)
    parked = not got
    seq = pub.publish("ch", {"x": 1}, key="k1")
    t.join(5)
    return parked, seq, [(s, k, m["x"]) for s, k, m in got], t.is_alive()


def test_publisher_long_poll_blocks_until_publish():
    assert _each(_long_poll) == [True, 1, [[1, "k1", 1]], False]


def _seq_and_key_filter(pkg):
    pub = _sub(pkg, "util.pubsub").Publisher(max_buffer=3)
    seqs = [pub.publish("ch", m, key=k) for m, k in
            (("a", "k1"), ("b", "k2"), ("c", "k1"))]
    obs = [seqs, [m for _, _, m in pub.poll("ch", after_seq=0, key="k1",
                                            timeout=0)],
           [m for _, _, m in pub.poll("ch", after_seq=1, timeout=0)]]
    pub.publish("ch", "d")  # the buffer keeps the newest 3
    obs += [[s for s, _, _ in pub.poll("ch", after_seq=0, timeout=0)],
            pub.poll("other", timeout=0), pub.poll("ch", after_seq=4,
                                                   timeout=0.05),
            pub.latest_seq("ch"), pub.latest_seq("other")]
    mod = _sub(pkg, "util.pubsub")
    obs.append(mod.global_publisher() is mod.global_publisher())
    return obs


def test_publisher_seq_key_filter_and_bounded_buffer():
    assert _each(_seq_and_key_filter) == [
        [1, 2, 3], ["a", "c"], ["b", "c"], [2, 3, 4], [], [], 4, 0, True]


def _wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.02)


def _subscriber(pkg):
    mod = _sub(pkg, "util.pubsub")
    pub = mod.Publisher()
    sub = mod.Subscriber(pub)
    seen, only = [], []
    sub.subscribe("events", lambda k, m: seen.append((k, m)))
    sub.subscribe("events", lambda k, m: only.append(m), key="k1")
    sub.subscribe("events", lambda k, m: 1 / 0)  # isolated
    for i in range(5):
        pub.publish("events", i, key=f"k{i % 2}")
    _wait_for(lambda: len(seen) == 5 and len(only) == 2)
    sub.unsubscribe("events", key="k1")
    pub.publish("events", 5, key="k1")
    _wait_for(lambda: len(seen) == 6)
    sub.close()
    return [m for _, m in seen], [k for k, _ in seen], only


def test_subscriber_dispatches_in_order_with_key_filter():
    assert _each(_subscriber) == [[0, 1, 2, 3, 4, 5],
                                  ["k0", "k1", "k0", "k1", "k0", "k1"],
                                  [1, 3]]


# -------------------------------------------- tests/test_forensics.py:370-440
@contextlib.contextmanager
def _postmortem_dir(pkg, d):
    """The package's recorder writing to ``d`` with no flood control."""
    fr = _sub(pkg, "util.flight_recorder")
    old = {k: os.environ.get(k) for k in ("RAY_TPU_POSTMORTEM_DIR",
                                          "RAY_TPU_POSTMORTEM_MIN_INTERVAL_S",
                                          "RAY_TPU_HANG_WATCHDOG")}
    os.environ.update(RAY_TPU_POSTMORTEM_DIR=d,
                      RAY_TPU_POSTMORTEM_MIN_INTERVAL_S="0",
                      RAY_TPU_HANG_WATCHDOG="0")
    fr.reset_recorder()
    try:
        yield fr
    finally:
        fr.reset_recorder()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _forensics(pkg, d):
    fx = _sub(pkg, "util.forensics")
    st = _sub(pkg, "util.state")
    with _postmortem_dir(pkg, d) as fr:
        rec = fr.FlightRecorder()
        rec.tap_span({"name": "serve.request", "start": 1.0, "end": 2.0,
                      "status": "OK"})
        rec.record_event("stall:w0", {"stacks": {}}, now=3.0, kind="stall",
                         status="ERROR")
        rec.dump("first", now=10.0)
        rec.dump("second", now=20.0)
        rows = fx.list_postmortems()
        obs = {
            "reasons": [r["reason"] for r in rows],
            "pids": all(r["pid"] == os.getpid() for r in rows),
            "stalls": rows[0]["stalls"],
            "ring_events": rows[0]["ring_events"] >= 2,
            "row_keys": sorted(rows[0]),
        }
        with open(os.path.join(d, "999-torn.json"), "w") as f:
            f.write('{"pid": 1, "re')
        obs["torn_skipped"] = len(fx.list_postmortems())
        pm_id = rows[0]["id"]
        obs["load"] = [fx.load_postmortem(pm_id)["reason"],
                       fx.load_postmortem("no-such-id"),
                       fx.load_postmortem("../../etc/passwd"),
                       fx.load_postmortem(".hidden")]
        bundle = fx.build_bundle(window_s=60.0)
        obs["bundle"] = [bundle["schema"], len(bundle["dumps"]),
                         all("id" in x for x in bundle["dumps"]),
                         [r["name"] for r in bundle["stalls"]],
                         "series" in bundle["timeseries"],
                         isinstance(bundle["train_runs"], list),
                         sorted(bundle)]
        events = fx.bundle_chrome_trace(bundle)
        obs["lanes"] = sorted({e["pid"] for e in events}) == [
            f"pid:{os.getpid()}"]
        obs["events"] = sorted(
            (e["ph"], e["name"], e.get("cname", ""), e["tid"])
            for e in events if e["name"] in ("serve.request", "stall:w0")
            or e["name"].startswith(("stall:", "dump:")))
        filtered = st.list_postmortems(filters=[("reason", "=", "first")])
        obs["state"] = [[r["reason"] for r in filtered],
                        st.get_postmortem(filtered[0]["id"])["reason"]]
        api = _sub(pkg, "_private.metrics_agent")._api_payload
        call = (lambda p: api(None, p)) if pkg is ray_tpu else api
        obs["api"] = [[r["reason"] for r in call("/api/postmortems")],
                      call(f"/api/postmortems/{rows[0]['id']}")["reason"],
                      len(call("/api/postmortems/bundle")["dumps"]),
                      call("/api/postmortems/nope")]
    return obs


def test_forensics_index_bundle_timeline_state_and_routes(tmp_path):
    obs = _each(lambda pkg: _forensics(pkg, str(tmp_path / pkg.__name__)))
    assert obs["reasons"] == ["second", "first"] and obs["stalls"] == 1
    assert obs["torn_skipped"] == 2
    assert obs["load"] == ["second", None, None, None]
    assert ["i", "stall:stall:w0", "terrible", "stall"] in obs["events"]
    assert ["X", "serve.request", "", "serve.request"] in obs["events"]


# ------------------------------------------- tests/test_observability.py:301
def _fetch(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def _http_state(pkg):
    agent_mod = _sub(pkg, "_private.metrics_agent")
    st = _sub(pkg, "util.state")
    runtime = _sub(pkg, "_private.runtime").get_runtime()

    @pkg.remote
    class Pinger:
        def ping(self):
            return "pong"

    a = Pinger.options(name="obs-pinger").remote()
    obs = {"pong": pkg.get(a.ping.remote())}
    agent = agent_mod.MetricsAgent(runtime)
    try:
        got = {p: _fetch(agent.port, p) for p in (
            "/api/actors", "/api/tasks", "/api/nodes", "/api/objects",
            "/api/placement_groups")}
        obs["status"] = {p: s for p, (s, _) in got.items()}
        obs["pinger"] = any(r.get("name") == "obs-pinger"
                            for r in got["/api/actors"][1])
        obs["ping_task"] = any("ping" in str(r.get("name", ""))
                               for r in got["/api/tasks"][1])
        obs["nodes"] = len(got["/api/nodes"][1])

        def same(rows):
            return json.loads(json.dumps(rows, default=str))

        obs["equal_to_library"] = [
            got["/api/actors"][1] == same(st.list_actors()),
            got["/api/tasks"][1] == same(st.list_tasks()),
            got["/api/nodes"][1] == same(st.list_nodes())]
    finally:
        agent.stop()
    return obs


def test_http_state_api_endpoints():
    obs = _parity(_http_state)
    assert obs["pinger"] and obs["ping_task"] and obs["nodes"] == 1
    assert obs["equal_to_library"] == [True, True, True]


def test_http_jobs_route_lists_the_submitted_jobs(tmp_path, monkeypatch):
    """``/api/jobs`` peeks at the process's job manager: [] before one
    exists, then its jobs (the reference's route reads its package's
    ``job_manager`` function in place of the module and answers 500)."""
    from ray_tpu_torch._private.metrics_agent import MetricsAgent
    from ray_tpu_torch._private.runtime import get_runtime

    jm_mod = importlib.import_module("ray_tpu_torch.job.job_manager")
    monkeypatch.setattr(jm_mod, "_MANAGER", None)
    fresh_init(ray_tpu_torch, num_cpus=2)
    agent = MetricsAgent(get_runtime())
    try:
        assert _fetch(agent.port, "/api/jobs") == (200, [])
        assert jm_mod._MANAGER is None  # a GET creates no manager
        monkeypatch.setattr(jm_mod, "_MANAGER",
                            jm_mod.JobManager(log_root=str(tmp_path)))
        job_id = jm_mod.job_manager().submit_job(
            f"{sys.executable} -c 'print(1)'", submission_id="api-job")
        assert jm_mod.job_manager().wait_job(job_id, timeout=30) == \
            "SUCCEEDED"
        status, rows = _fetch(agent.port, "/api/jobs")
        assert status == 200 and rows == [{
            "job_id": "api-job", "status": "SUCCEEDED",
            "entrypoint": f"{sys.executable} -c 'print(1)'",
            "log_path": str(tmp_path / "api-job.log")}]
    finally:
        agent.stop()
        ray_tpu_torch.shutdown()

