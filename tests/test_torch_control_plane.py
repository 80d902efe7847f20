"""The port's control-plane substrate against the reference: the internal
KV (tests/test_control_plane.py's KV cases), the metrics registry's
Prometheus text, tracing's span nesting, and the object store cases of
tests/test_object_store.py that the thread tier keeps (refcount free,
nested refs, lineage reconstruction). Then the port's own use of the KV:
the serve controller's checkpoint of its applications.
"""

import gc
import importlib

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init, gc_paused

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------------------ the KV
def _kv_basic(pkg, tmp_path):
    kv = _mod(pkg, "_private.kv_store").KVStore()
    out = [kv.put(b"a", b"1"), kv.get(b"a"),
           kv.put(b"a", b"2", overwrite=False), kv.get(b"a")]
    kv.put(b"a", b"2")
    kv.put(b"a", b"other", namespace="ns2")
    kv.put(b"ab", b"x")
    out += [kv.get(b"a"), kv.get(b"a", namespace="ns2"),
            sorted(kv.keys(b"a")), kv.delete(b"a"), kv.delete(b"a"),
            kv.exists(b"a")]
    return out


def _kv_persistence_replay_and_compaction(pkg, tmp_path):
    KVStore = _mod(pkg, "_private.kv_store").KVStore
    path = str(tmp_path / f"{pkg}.jsonl")
    kv = KVStore(persist_path=path, compact_threshold=50)
    for i in range(100):  # crosses the compaction threshold
        kv.put(f"k{i}".encode(), f"v{i}".encode())
    kv.delete(b"k0")
    kv2 = KVStore(persist_path=path)  # "restart": replay the WAL
    return [kv2.get(b"k1"), kv2.get(b"k99"), kv2.get(b"k0"),
            sum(1 for _ in open(path)) <= 150]


def _kv_survives_torn_tail_write(pkg, tmp_path):
    KVStore = _mod(pkg, "_private.kv_store").KVStore
    path = str(tmp_path / f"{pkg}.jsonl")
    KVStore(persist_path=path).put(b"good", b"1")
    with open(path, "a") as f:
        f.write('{"op": "put", "ns": "", "k"')  # crash mid-record
    return KVStore(persist_path=path).get(b"good")


def _internal_kv_api(pkg, tmp_path):
    config = _mod(pkg, "_private.config").GLOBAL_CONFIG
    ikv = _mod(pkg, "experimental.internal_kv")
    old = (config.kv_persist, config.session_dir)
    config.kv_persist = True
    config.session_dir = str(tmp_path / pkg)
    try:
        ikv._internal_kv_reset()
        out = [ikv._internal_kv_initialized(),
               ikv._internal_kv_put("fn:abc", b"payload"),
               ikv._internal_kv_get("fn:abc"),
               ikv._internal_kv_exists("fn:abc"),
               ikv._internal_kv_list("fn:"),
               ikv._internal_kv_put("fn:abc", b"x", overwrite=False)]
        ikv._internal_kv_reset()  # restart: replay from the WAL
        out += [ikv._internal_kv_get("fn:abc"), ikv._internal_kv_del("fn:abc")]
    finally:
        config.kv_persist, config.session_dir = old
        ikv._internal_kv_reset()
    return out


# ---------------------------------------------------- metrics and tracing
def _metrics_prometheus_text(pkg, tmp_path):
    m = _mod(pkg, "util.metrics")
    reg = m.MetricsRegistry()
    saved, m._REGISTRY = m._REGISTRY, reg
    try:
        c = m.Counter("t_requests", "requests", tag_keys=("route",))
        g = m.Gauge("t_inflight", "inflight", tag_keys=("route",))
        h = m.Histogram("t_latency", "latency", boundaries=(0.1, 1.0),
                        tag_keys=("route",))
        c.inc(tags={"route": "/a"})
        c.inc(2.5, tags={"route": "/a"})
        c.inc(0, tags={"route": "/b"})
        g.set(3, tags={"route": "/a"})
        for v in (0.05, 0.5, 5.0):
            h.observe(v, tags={"route": "/a"})
        h.observe_batch([0.2, 0.3], tags={"route": "/b"})
        try:
            c.inc(tags={"nope": "x"})
        except ValueError:
            bad_tag = "ValueError"
        return [reg.prometheus_text(), bad_tag, h.get({"route": "/a"}),
                h.percentile(50, {"route": "/a"}),
                m.percentile_from_buckets([1.0, 2.0], [0, 4, 0], 50)]
    finally:
        m._REGISTRY = saved


def _tracing_nesting(pkg, tmp_path):
    tracing = _mod(pkg, "util.tracing")
    tracing.clear_spans()
    tracing.enable_tracing()
    try:
        with tracing.span("outer", attributes={"a": 1}):
            with tracing.span("inner"):
                pass
            tracing.record_span("after", 1.0, 2.0)
        try:
            with tracing.span("failing"):
                raise KeyError("x")
        except KeyError:
            pass
        spans = tracing.exported_spans()
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()
    by_id = {s["span_id"]: s for s in spans}
    return sorted((s["name"], by_id[s["parent_id"]]["name"]
                   if s["parent_id"] in by_id else None, s["status"],
                   len({s["trace_id"]} & {t["trace_id"] for t in spans
                                          if t["name"] == "outer"}))
                  for s in spans)


# ------------------------------------------------------------ object store
def _refcount_free_on_release(pkg, tmp_path):
    pkg_mod = importlib.import_module(pkg)
    fresh_init(pkg_mod, num_cpus=2)
    try:
        store = _mod(pkg, "_private.runtime").get_runtime().store
        ref = pkg_mod.put(np.zeros(1000))
        oid = ref.id
        before = store.contains(oid)
        del ref
        gc.collect()
        return [before, store.contains(oid)]
    finally:
        pkg_mod.shutdown()


def _refs_alive_while_nested(pkg, tmp_path):
    pkg_mod = importlib.import_module(pkg)
    fresh_init(pkg_mod, num_cpus=2)
    try:
        store = _mod(pkg, "_private.runtime").get_runtime().store
        ref = pkg_mod.put("value")
        ref2 = pkg_mod.get(pkg_mod.put([ref]))[0]
        oid = ref.id
        del ref
        gc.collect()
        return [store.contains(oid), pkg_mod.get(ref2)]
    finally:
        pkg_mod.shutdown()


def _lineage_reconstruction(pkg, tmp_path):
    pkg_mod = importlib.import_module(pkg)
    fresh_init(pkg_mod, num_cpus=2)
    try:
        runtime = _mod(pkg, "_private.runtime").get_runtime()
        ref = pkg_mod.remote(lambda: np.arange(100)).remote()
        first = pkg_mod.get(ref).tolist()
        runtime.store.free(ref.id)  # the value is lost
        return [first, pkg_mod.get(ref, timeout=30).tolist()]
    finally:
        pkg_mod.shutdown()


CASES = [_kv_basic, _kv_persistence_replay_and_compaction,
         _kv_survives_torn_tail_write, _internal_kv_api,
         _metrics_prometheus_text, _tracing_nesting,
         _refcount_free_on_release, _refs_alive_while_nested,
         _lineage_reconstruction]

EXPECTED = {
    "_kv_basic": [True, b"1", False, b"1", b"2", b"other", [b"a", b"ab"], 1,
                  0, False],
    "_kv_persistence_replay_and_compaction": [b"v1", b"v99", None, True],
    "_kv_survives_torn_tail_write": b"1",
    "_internal_kv_api": [True, False, b"payload", True, [b"fn:abc"], True,
                         b"payload", 1],
    "_refcount_free_on_release": [True, False],
    "_refs_alive_while_nested": [True, "value"],
    "_lineage_reconstruction": [list(range(100))] * 2,
}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_")
                                             for c in CASES])
def test_port_control_plane_matches_reference(case, tmp_path):
    with gc_paused():
        ref = case("ray_tpu", tmp_path)
        port = case("ray_tpu_torch", tmp_path)
    if case.__name__ in EXPECTED:
        assert ref == EXPECTED[case.__name__]
    assert port == ref


# --------------------------------------- the controller's checkpoint (port)
class _Restorable:
    """A deployment importable by path: the checkpoint pickles it."""

    def __call__(self):
        return "restored"


def test_controller_restores_apps_from_the_kv_wal(tmp_path):
    """With the KV's WAL on, a new controller (the old one gone without
    deleting its apps) redeploys them from the checkpoint; without the WAL
    nothing is written, so bound weights are never copied into the KV."""
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.experimental import internal_kv as ikv
    from ray_tpu_torch.serve import api
    from ray_tpu_torch.serve.controller import ServeController

    old = (GLOBAL_CONFIG.kv_persist, GLOBAL_CONFIG.session_dir)
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        serve.run(serve.deployment(_Restorable).bind(), name="plain",
                  route_prefix=None)
        assert ikv._internal_kv_list("", namespace=ServeController._KV_NS) == []
        serve.delete("plain")

        GLOBAL_CONFIG.kv_persist = True
        GLOBAL_CONFIG.session_dir = str(tmp_path)
        ikv._internal_kv_reset()
        serve.run(serve.deployment(_Restorable).bind(), name="kept",
                  route_prefix=None)
        assert ikv._internal_kv_list(
            "", namespace=ServeController._KV_NS) == [b"kept"]
        # The controller dies without deleting its apps; a restart of the
        # process replays the WAL into a fresh KV.
        ray_tpu_torch.kill(api._state["controller"])
        api._state["controller"] = None
        ikv._internal_kv_reset()
        assert "kept#_Restorable" in serve.status()
        handle = serve.get_app_handle("kept")
        assert handle.remote().result(timeout_s=30) == "restored"
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        GLOBAL_CONFIG.kv_persist, GLOBAL_CONFIG.session_dir = old
        ikv._internal_kv_reset()
