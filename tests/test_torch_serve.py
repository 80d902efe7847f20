"""The port's serve control plane and HTTP proxy (ray_tpu_torch.serve)
against the reference (ray_tpu.serve), on the cases of tests/test_serve.py
and tests/test_serve_streaming_proxy.py.

Each case is one body run against both packages, one after the other, each
on a fresh runtime and serve instance torn down before the other starts
(the two runtimes never run at once). A case returns what it observed —
handle results, and for HTTP the status, Content-Type and body bytes — and
the port's observation must equal the reference's. Every HTTP call has a
timeout.
"""

import asyncio
import http.client
import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve
from _torch_runtimes import fresh_init, gc_paused


def _serve(pkg):
    return importlib.import_module(pkg.__name__ + ".serve")


def _proxy(pkg):
    return importlib.import_module(pkg.__name__ + ".serve.api")._state["proxy"]


def _host_port(pkg):
    opts = _proxy(pkg)._options
    return opts.host, opts.port


def _http(pkg, path, method="GET", body=None, headers=None, timeout=30):
    """(status, Content-Type, Transfer-Encoding, body bytes) of one request
    on a fresh connection."""
    conn = http.client.HTTPConnection(*_host_port(pkg), timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        try:
            data = resp.read()
        except http.client.IncompleteRead as e:  # a truncated stream
            data = e.partial
        return (resp.status, resp.getheader("Content-Type"),
                resp.getheader("Transfer-Encoding"), data)
    finally:
        conn.close()


def _wait_for_zero_ongoing(pkg, handle, timeout=30.0):
    """Poll every replica's ongoing-request count until all slots drained."""
    scheduler = handle._get_router()._scheduler
    deadline = time.time() + timeout
    ongoing = None
    while time.time() < deadline:
        with scheduler._lock:
            replicas = [dict(r) for r in scheduler._replicas]
        counts = [r["actor"].get_num_ongoing_requests.remote()
                  for r in replicas]
        ongoing = sum(pkg.get(c, timeout=10) for c in counts) if counts else None
        if ongoing == 0:
            return 0
        time.sleep(0.3)
    return ongoing


# ----------------------------------------------------- tests/test_serve.py
def deploy_and_call_function(pkg):
    serve = _serve(pkg)

    @serve.deployment
    def echo(x):
        return {"got": x}

    handle = serve.run(echo.bind(), name="echo_app", route_prefix=None)
    return handle.remote(42).result(timeout_s=10)


def deploy_class_with_state(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=1)
    class Counter:
        def __init__(self, start):
            self.count = start

        def __call__(self):
            self.count += 1
            return self.count

        def get(self):
            return self.count

    handle = serve.run(Counter.bind(10), name="counter", route_prefix=None)
    return [handle.remote().result(timeout_s=10),
            handle.remote().result(timeout_s=10),
            handle.get.remote().result(timeout_s=10)]


def composition_with_handles(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Ingress:
        def __init__(self, doubler):
            self.doubler = doubler

        async def __call__(self, x):
            return await self.doubler.remote(x) + 1

    handle = serve.run(Ingress.bind(Doubler.bind()), name="compose",
                       route_prefix=None)
    return handle.remote(5).result(timeout_s=15)


def multiple_replicas_and_pow2(pkg):
    serve = _serve(pkg)
    context = importlib.import_module(pkg.__name__ + ".serve.context")

    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __call__(self):
            return context.get_internal_replica_context().replica_id

    handle = serve.run(WhoAmI.bind(), name="who", route_prefix=None)
    seen = {handle.remote().result(timeout_s=10) for _ in range(30)}
    return [len(seen) >= 2, all(s.startswith("WhoAmI#") for s in seen)]


def reconfigure_and_rolling_update(pkg):
    serve = _serve(pkg)

    @serve.deployment(user_config={"threshold": 1})
    class Configurable:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self):
            return self.threshold

    handle = serve.run(Configurable.bind(), name="cfg", route_prefix=None)
    before = handle.remote().result(timeout_s=10)
    serve.run(Configurable.options(user_config={"threshold": 7}).bind(),
              name="cfg", route_prefix=None)
    deadline = time.time() + 20
    while time.time() < deadline:
        if handle.remote().result(timeout_s=10) == 7:
            break
        time.sleep(0.1)
    return [before, handle.remote().result(timeout_s=10)]


def http_proxy_end_to_end(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Api:
        async def __call__(self, request):
            body = await request.json()
            return {"path": request.path, "sum": sum(body["xs"]),
                    "q": dict(request.query_params)}

    serve.run(Api.bind(), name="api", route_prefix="/api")
    addr = _proxy(pkg).address
    data = json.dumps({"xs": [1, 2, 3]}).encode()
    req = urllib.request.Request(f"{addr}/api?a=1&b=x%20y", data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        post = (resp.status, resp.headers["Content-Type"], resp.read())
    try:
        urllib.request.urlopen(f"{addr}/nope", timeout=10)
        missing = None
    except urllib.error.HTTPError as e:
        missing = (e.code, e.headers["Content-Type"], e.read())
    return [post, missing]


def autoscaling_scales_up(pkg):
    serve = _serve(pkg)

    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0,
                            "upscale_delay_s": 0.2,
                            "metrics_interval_s": 0.1},
        max_ongoing_requests=10)
    class Slow:
        async def __call__(self):
            await asyncio.sleep(1.0)
            return "done"

    handle = serve.run(Slow.bind(), name="auto", route_prefix=None)
    responses = [handle.remote() for _ in range(50)]
    deadline = time.time() + 20
    scaled = False
    while time.time() < deadline:
        if serve.status().get("auto#Slow", {}).get("running_replicas", 0) >= 2:
            scaled = True
            break
        time.sleep(0.1)
    return [scaled, {r.result(timeout_s=30) for r in responses}]


def delete_application(pkg):
    serve = _serve(pkg)

    @serve.deployment
    def f():
        return "alive"

    serve.run(f.bind(), name="temp", route_prefix=None)
    before = "temp#f" in serve.status()
    serve.delete("temp")
    deadline = time.time() + 10
    while time.time() < deadline and "temp#f" in serve.status():
        time.sleep(0.05)
    return [before, "temp#f" in serve.status()]


# ------------------------------------- tests/test_serve_streaming_proxy.py
def _deploy_streamer(pkg, name="stream_app", prefix="/stream", delay=0.0,
                     fail_at=None):
    serve = _serve(pkg)

    @serve.deployment
    class Streamer:
        def __call__(self, request):
            n = int(request.query_params.get("n", "4"))
            for i in range(n):
                if fail_at is not None and i == fail_at:
                    raise RuntimeError("replica exploded mid-stream")
                if delay:
                    time.sleep(delay)
                yield f"tok{i} "

    serve.run(Streamer.bind(), name=name, route_prefix=prefix)


def http_proxy_streams_chunks(pkg):
    _deploy_streamer(pkg)
    return _http(pkg, "/stream?n=5")


def http_proxy_streams_incrementally(pkg):
    """Chunks arrive BEFORE the generator finishes."""
    _deploy_streamer(pkg, name="slow_app", prefix="/slow", delay=0.3)
    conn = http.client.HTTPConnection(*_host_port(pkg), timeout=60)
    try:
        t0 = time.time()
        conn.request("GET", "/slow?n=4")
        resp = conn.getresponse()
        first = resp.read(5)  # one item is 5 bytes ("tokN ")
        t_first = time.time() - t0
        rest = resp.read()
        t_all = time.time() - t0
    finally:
        conn.close()
    return [first, rest, t_first < t_all - 0.25]


def http_proxy_sse_framing(pkg):
    _deploy_streamer(pkg, name="sse_app", prefix="/sse")
    return _http(pkg, "/sse?n=2", headers={"Accept": "text/event-stream"})


def http_proxy_mid_stream_error_truncates(pkg):
    _deploy_streamer(pkg, name="boom_app", prefix="/boom", fail_at=2)
    return _http(pkg, "/boom?n=5")


def http_proxy_error_before_first_chunk_is_500(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class FailFirst:
        def __call__(self, request):
            raise RuntimeError("dead on arrival")
            yield  # pragma: no cover — makes this a generator fn

    serve.run(FailFirst.bind(), name="ff_app", route_prefix="/ff")
    status, ctype, te, body = _http(pkg, "/ff")
    # The body carries the replica's traceback, whose file paths differ
    # between the packages: its head and the cause are compared.
    return [status, ctype, te, body.split(b"(")[0],
            b"dead on arrival" in body]


def http_answer_types_and_errors(pkg):
    """The unary answer's bytes for each result type (JSON, text, bytes),
    a failed request's 500 and a request past the queue allowance's 503."""
    serve = _serve(pkg)

    @serve.deployment
    class Kinds:
        def __call__(self, request):
            kind = request.query_params["kind"]
            if kind == "fail":
                raise ValueError("bad request")
            return {"json": {"a": [1, 2.5, None], "b": "ü"}, "text": "héllo",
                    "bytes": b"\x00\x01raw"}[kind]

    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class Slow:
        def __call__(self, request):
            time.sleep(1.0)
            return "slow"

    serve.run(Kinds.bind(), name="kinds", route_prefix="/kinds")
    serve.run(Slow.bind(), name="bp", route_prefix="/bp")
    out = [_http(pkg, f"/kinds?kind={k}") for k in ("json", "text", "bytes")]
    status, ctype, _, body = _http(pkg, "/kinds?kind=fail")
    out.append([status, ctype, body.split(b"(")[0], b"bad request" in body])
    first = {}
    t = threading.Thread(target=lambda: first.update(r=_http(pkg, "/bp")))
    t.start()
    scheduler = None
    deadline = time.time() + 20
    while time.time() < deadline:
        handle = _proxy(pkg)._handles.get("bp")
        if handle is not None:
            scheduler = handle._get_router()._scheduler
            if scheduler.total_inflight() == 1:
                break
        time.sleep(0.01)
    shed = _http(pkg, "/bp")
    t.join(timeout=30)
    assert not t.is_alive()
    out += [shed, first["r"]]
    return out


def http_streamed_item_types(pkg):
    """ndjson for items that are neither bytes nor str, bytes passed
    through, SSE framing of each, and an empty stream."""
    serve = _serve(pkg)

    @serve.deployment
    class Mixed:
        def __call__(self, request):
            n = int(request.query_params.get("n", "4"))
            items = [b"raw\x00", "text\n", {"i": 1}, [1, "two"]]
            for i in range(n):
                yield items[i % len(items)]

    serve.run(Mixed.bind(), name="mixed", route_prefix="/mixed")
    return [_http(pkg, "/mixed?n=4"),
            _http(pkg, "/mixed?n=4", headers={"Accept": "text/event-stream"}),
            _http(pkg, "/mixed?n=0")]


def http_disconnects_under_concurrent_load(pkg):
    """N concurrent streams, half the clients vanish mid-stream: surviving
    streams complete and every replica slot comes back."""
    serve = _serve(pkg)

    @serve.deployment(max_ongoing_requests=16)
    class Tokens:
        def __call__(self, request):
            n = int(request.query_params.get("n", "60"))
            for i in range(n):
                time.sleep(0.01)
                yield f"t{i} "

    handle = serve.run(Tokens.bind(), name="load_app", route_prefix="/load")
    host, port = _host_port(pkg)
    results = {}

    def client(idx, abort):
        conn = http.client.HTTPConnection(host, port, timeout=60)
        try:
            conn.request("GET", "/load?n=60")
            resp = conn.getresponse()
            if abort:
                resp.read(8)  # stream live, then vanish mid-flight
                conn.sock.shutdown(socket.SHUT_RDWR)
                results[idx] = "aborted"
                return
            results[idx] = len(resp.read().split())
        except Exception as e:  # noqa: BLE001 — the observation
            results[idx] = repr(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i, i % 2 == 1))
               for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    hung = any(t.is_alive() for t in threads)
    ongoing = _wait_for_zero_ongoing(pkg, handle)
    fresh = _http(pkg, "/load?n=5")[3].split()
    return [hung, sorted(results.items()), ongoing, len(fresh)]


def _endless(pkg, name, prefix):
    serve = _serve(pkg)

    @serve.deployment
    class Endless:
        def __call__(self, request):
            i = 0
            while True:
                time.sleep(0.05)
                yield f"x{i}"
                i += 1

    return serve.run(Endless.bind(), name=name, route_prefix=prefix)


def http_client_disconnect_releases_stream(pkg):
    handle = _endless(pkg, "endless_app", "/endless")
    conn = http.client.HTTPConnection(*_host_port(pkg), timeout=30)
    conn.request("GET", "/endless")
    live = bool(conn.getresponse().read(2))
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    return [live, _wait_for_zero_ongoing(pkg, handle)]


def http_disconnect_decrements_router_inflight(pkg):
    _endless(pkg, "rinf_app", "/rinf")
    conn = http.client.HTTPConnection(*_host_port(pkg), timeout=30)
    conn.request("GET", "/rinf")
    live = bool(conn.getresponse().read(2))
    scheduler = _proxy(pkg)._handles["rinf_app"]._get_router()._scheduler
    during = scheduler.total_inflight()
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    deadline = time.time() + 30
    while scheduler.total_inflight() != 0 and time.time() < deadline:
        time.sleep(0.2)
    return [live, during, scheduler.total_inflight()]


def handle_stream_cancel_releases_replica_and_router(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Tracked:
        def __init__(self):
            self.cleaned_up = False

        def tokens(self, n):
            try:
                for i in range(n):
                    time.sleep(0.02)
                    yield i
            finally:
                self.cleaned_up = True

        def was_cleaned_up(self):
            return self.cleaned_up

    handle = serve.run(Tracked.bind(), name="cancel_app", route_prefix=None)
    gen = handle.options(method_name="tokens", stream=True).remote(1000)
    first = next(iter(gen))
    router = handle._get_router()
    during = router._scheduler.total_inflight()
    gen.cancel()
    deadline = time.time() + 30
    while not handle.was_cleaned_up.remote().result(timeout_s=10) \
            and time.time() < deadline:
        time.sleep(0.1)
    cleaned = handle.was_cleaned_up.remote().result(timeout_s=10)
    ongoing = _wait_for_zero_ongoing(pkg, handle)
    deadline = time.time() + 10
    while router._scheduler.total_inflight() != 0 and time.time() < deadline:
        time.sleep(0.05)
    return [first, during, cleaned, ongoing, router._scheduler.total_inflight()]


CASES = [
    deploy_and_call_function, deploy_class_with_state,
    composition_with_handles, multiple_replicas_and_pow2,
    reconfigure_and_rolling_update, http_proxy_end_to_end,
    autoscaling_scales_up, delete_application, http_proxy_streams_chunks,
    http_proxy_streams_incrementally, http_proxy_sse_framing,
    http_proxy_mid_stream_error_truncates,
    http_proxy_error_before_first_chunk_is_500, http_answer_types_and_errors,
    http_streamed_item_types, http_disconnects_under_concurrent_load,
    http_client_disconnect_releases_stream,
    http_disconnect_decrements_router_inflight,
    handle_stream_cancel_releases_replica_and_router,
]

#: What the reference observes where the case pins it down (the assertions
#: of the reference tests these cases come from).
EXPECTED = {
    "deploy_and_call_function": {"got": 42},
    "deploy_class_with_state": [11, 12, 12],
    "composition_with_handles": 11,
    "multiple_replicas_and_pow2": [True, True],
    "reconfigure_and_rolling_update": [1, 7],
    "autoscaling_scales_up": [True, {"done"}],
    "delete_application": [True, False],
    "http_proxy_streams_chunks": (
        200, "application/octet-stream", "chunked",
        b"tok0 tok1 tok2 tok3 tok4 "),
    "http_proxy_streams_incrementally": [b"tok0 ", b"tok1 tok2 tok3 ", True],
    "http_proxy_sse_framing": (200, "text/event-stream", "chunked",
                               b"data: tok0 \n\ndata: tok1 \n\n"),
    "http_proxy_mid_stream_error_truncates": (
        200, "application/octet-stream", "chunked", b"tok0 tok1 "),
    "http_proxy_error_before_first_chunk_is_500": [
        500, "text/plain; charset=utf-8", None, b"Internal error: TaskError",
        True],
    "http_disconnects_under_concurrent_load": [
        False, [(i, 60 if i % 2 == 0 else "aborted") for i in range(12)], 0,
        5],
    "http_client_disconnect_releases_stream": [True, 0],
    "http_disconnect_decrements_router_inflight": [True, 1, 0],
    "handle_stream_cancel_releases_replica_and_router": [0, 1, True, 0, 0],
}


# ---------------------------------------- tests/test_serve_health.py
def user_health_check_failure_triggers_replacement(pkg):
    serve = _serve(pkg)
    context = importlib.import_module(pkg.__name__ + ".serve.context")
    dstate = importlib.import_module(pkg.__name__ + ".serve.deployment_state")

    @serve.deployment(num_replicas=1, health_check_period_s=0.1,
                      health_check_timeout_s=2.0)
    class Flaky:
        def __init__(self):
            self.broken = False

        def break_health(self):
            self.broken = True
            return "broken"

        def check_health(self):
            if self.broken:
                raise RuntimeError("user health check failing")

        def __call__(self):
            return context.get_internal_replica_context().replica_id

    handle = serve.run(Flaky.bind(), name="flaky", route_prefix=None)
    first = handle.remote().result(timeout_s=10)
    tags = {"deployment": "flaky#Flaky"}
    before = dstate.RESTARTS_COUNTER.get(tags=tags)
    broken = handle.break_health.remote().result(timeout_s=10)
    deadline = time.time() + 20
    second = first
    while time.time() < deadline and second == first:
        try:
            second = handle.remote().result(timeout_s=10)
        except Exception:  # noqa: BLE001 — the replica is being replaced
            pass
        time.sleep(0.1)
    return [broken, second != first,
            dstate.RESTARTS_COUNTER.get(tags=tags) > before,
            serve.status()["flaky#Flaky"]["replica_restarts"] >= 1]


def health_gauges_track_replica_states(pkg):
    serve = _serve(pkg)
    dstate = importlib.import_module(pkg.__name__ + ".serve.deployment_state")

    @serve.deployment(num_replicas=2, health_check_period_s=0.1,
                      graceful_shutdown_wait_loop_s=1.0)
    class Pair:
        def __init__(self):
            self.broken = False

        def break_health(self):
            self.broken = True
            return "broken"

        def check_health(self):
            if self.broken:
                raise RuntimeError("failing")

        def __call__(self):
            return "ok"

    handle = serve.run(Pair.bind(), name="pair", route_prefix=None)
    tags = {"deployment": "pair#Pair"}
    deadline = time.time() + 10
    while time.time() < deadline and dstate.HEALTHY_GAUGE.get(tags=tags) < 2:
        time.sleep(0.05)
    healthy = dstate.HEALTHY_GAUGE.get(tags=tags)
    handle.break_health.remote().result(timeout_s=10)
    saw_unhealthy = False
    deadline = time.time() + 15
    while time.time() < deadline and not saw_unhealthy:
        saw_unhealthy = dstate.UNHEALTHY_GAUGE.get(tags=tags) >= 1
        time.sleep(0.02)
    deadline = time.time() + 20
    while time.time() < deadline:
        st = serve.status()["pair#Pair"]
        if st["running_replicas"] == 2 and st["unhealthy_replicas"] == 0:
            break
        time.sleep(0.1)
    st = serve.status()["pair#Pair"]
    return [healthy, saw_unhealthy, st["running_replicas"], st["status"]]


def graceful_drain_lets_inflight_finish(pkg):
    serve = _serve(pkg)

    @serve.deployment(graceful_shutdown_wait_loop_s=5.0,
                      graceful_shutdown_timeout_s=10.0)
    class Slow:
        def __call__(self, delay):
            time.sleep(delay)
            return "finished"

        def stream(self, n):
            for i in range(n):
                time.sleep(0.15)
                yield i

    handle = serve.run(Slow.bind(), name="drain", route_prefix=None)
    first = handle.remote(0).result(timeout_s=10)
    inflight = handle.remote(1.5)
    gen = handle.options(method_name="stream", stream=True).remote(8)
    time.sleep(0.3)  # both are mid-flight on the replica
    serve.delete("drain")
    out = [first, inflight.result(timeout_s=30), list(gen)]
    deadline = time.time() + 15
    while time.time() < deadline and "drain#Slow" in serve.status():
        time.sleep(0.1)
    return out + ["drain#Slow" in serve.status()]


def hard_kill_after_graceful_timeout(pkg):
    serve = _serve(pkg)

    @serve.deployment(graceful_shutdown_wait_loop_s=0.2,
                      graceful_shutdown_timeout_s=0.5)
    class Wedged:
        def __call__(self):
            time.sleep(5)
            return "never"

    handle = serve.run(Wedged.bind(), name="wedged", route_prefix=None)
    resp = handle.remote()  # holds a request on the replica
    time.sleep(0.2)
    t0 = time.time()
    serve.delete("wedged")
    deadline = time.time() + 15
    while time.time() < deadline and "wedged#Wedged" in serve.status():
        time.sleep(0.05)
    out = ["wedged#Wedged" in serve.status(), time.time() - t0 < 4]
    del resp
    return out


def rolling_update_respects_availability_floor(pkg):
    serve = _serve(pkg)

    @serve.deployment(num_replicas=3, max_unavailable=1,
                      health_check_period_s=0.1, user_config={"version": 1})
    class Versioned:
        def __init__(self):
            self.version = None

        def reconfigure(self, config):
            time.sleep(0.3)  # a slow start widens the window the floor covers
            self.version = config["version"]

        def __call__(self):
            return self.version

    handle = serve.run(Versioned.bind(), name="floor", route_prefix=None)
    before = handle.remote().result(timeout_s=10)
    serve.run(Versioned.options(user_config={"version": 2}).bind(),
              name="floor", route_prefix=None)
    min_running = 99
    converged = False
    deadline = time.time() + 40
    while time.time() < deadline and not converged:
        min_running = min(min_running,
                          serve.status()["floor#Versioned"]["running_replicas"])
        converged = {handle.remote().result(timeout_s=10)
                     for _ in range(6)} == {2}
        time.sleep(0.05)
    return [before, converged, min_running >= 2]


# ------------------------- tests/test_serve_extras.py (streaming handles)
def streaming_handle_sync_and_async_generators(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Streamer:
        def tokens(self, n):
            for i in range(n):
                yield f"tok{i}"

        async def atokens(self, n):
            for i in range(n):
                await asyncio.sleep(0.001)
                yield i * 10

    handle = serve.run(Streamer.bind(), name="streamer", route_prefix=None)
    return [list(handle.options(method_name="tokens", stream=True).remote(4)),
            list(handle.options(method_name="atokens", stream=True).remote(3))]


def streaming_cancel_and_errors(pkg):
    serve = _serve(pkg)

    @serve.deployment
    class Faulty:
        def boom(self, n):
            yield "ok"
            raise RuntimeError("mid-stream failure")

        def endless(self):
            i = 0
            while True:
                yield i
                i += 1

    handle = serve.run(Faulty.bind(), name="faulty", route_prefix=None)
    gen = handle.options(method_name="boom", stream=True).remote(1)
    out = [next(gen)]
    try:
        next(gen)
    except Exception as e:  # noqa: BLE001 — the observation
        out.append(["mid-stream failure" in str(e), type(e).__name__])
    gen2 = handle.options(method_name="endless", stream=True).remote()
    out += [next(gen2), next(gen2)]
    gen2.cancel()
    out.append(next(gen2, "stopped"))
    return out


# ------------------------------ tests/test_serve_tracing.py (no batching)
def http_request_single_connected_trace(pkg):
    """One HTTP request is one trace: the proxy's root span, the route,
    the actor call's submit and execute spans and the replica span, each
    parented on the one before."""
    serve = _serve(pkg)
    tracing = importlib.import_module(pkg.__name__ + ".util.tracing")

    @serve.deployment
    class Hello:
        async def __call__(self, request):
            return "hi"

    serve.run(Hello.bind(), name="traceapp", route_prefix="/trace")
    _http(pkg, "/trace")  # warm: the route table and the router
    tracing.clear_spans()
    tracing.enable_tracing()
    try:
        status = _http(pkg, "/trace")[0]
        deadline = time.time() + 10
        while time.time() < deadline and not any(
                s["name"] == "serve.http_request"
                for s in tracing.exported_spans()):
            time.sleep(0.02)
        spans = tracing.exported_spans()
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()
    root = next(s for s in spans if s["name"] == "serve.http_request")
    trace = {s["span_id"]: s for s in spans
             if s["trace_id"] == root["trace_id"]}
    chain = []
    for s in sorted(trace.values(), key=lambda s: s["start"]):
        parent = trace.get(s["parent_id"])
        chain.append((s["name"], parent["name"] if parent else None))
    return [status, chain]


def status_reports_latency_rollup_and_exemplars(pkg):
    serve = _serve(pkg)
    tracing = importlib.import_module(pkg.__name__ + ".util.tracing")
    um = importlib.import_module(pkg.__name__ + ".util.metrics")

    @serve.deployment
    class Hello:
        async def __call__(self, request):
            return "hi"

    serve.run(Hello.bind(), name="rollapp", route_prefix="/roll")
    tracing.enable_tracing()
    try:
        bodies = {_http(pkg, "/roll")[3] for _ in range(5)}
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()
    deadline = time.time() + 10
    while time.time() < deadline:
        st = serve.status().get("rollapp#Hello", {})
        if st.get("requests", 0) >= 5 and st.get("p50_latency_ms", 0) > 0:
            break
        time.sleep(0.1)
    st = serve.status()["rollapp#Hello"]
    text = um.registry().prometheus_text()
    buckets = [line for line in text.splitlines()
               if line.startswith("serve_request_latency_seconds_bucket")]
    return [bodies, st["requests"] >= 5, st["errors"],
            0 < st["p50_latency_ms"] <= st["p95_latency_ms"]
            <= st["p99_latency_ms"],
            any('# {trace_id="' in line for line in buckets),
            "serve_request_latency_seconds_sum" in text]


CASES += [
    user_health_check_failure_triggers_replacement,
    health_gauges_track_replica_states, graceful_drain_lets_inflight_finish,
    hard_kill_after_graceful_timeout,
    rolling_update_respects_availability_floor,
    streaming_handle_sync_and_async_generators, streaming_cancel_and_errors,
    http_request_single_connected_trace,
    status_reports_latency_rollup_and_exemplars,
]
EXPECTED.update({
    "user_health_check_failure_triggers_replacement": ["broken", True, True,
                                                       True],
    "health_gauges_track_replica_states": [2, True, 2, "HEALTHY"],
    "graceful_drain_lets_inflight_finish": ["finished", "finished",
                                            list(range(8)), False],
    "hard_kill_after_graceful_timeout": [False, True],
    "rolling_update_respects_availability_floor": [1, True, True],
    "streaming_handle_sync_and_async_generators": [
        ["tok0", "tok1", "tok2", "tok3"], [0, 10, 20]],
    "streaming_cancel_and_errors": ["ok", [True, "TaskError"], 0, 1,
                                    "stopped"],
    "status_reports_latency_rollup_and_exemplars": [{b"hi"}, True, 0, True,
                                                    True, True],
})


def _run(pkg, case):
    fresh_init(pkg, num_cpus=8)
    serve = _serve(pkg)
    try:
        serve.start(http_options={"port": 0})
        return case(pkg)
    finally:
        try:
            serve.shutdown()
        finally:
            pkg.shutdown()


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_port_serve_matches_reference(case):
    with gc_paused():
        ref = _run(ray_tpu, case)
    port = _run(ray_tpu_torch, case)
    if case.__name__ in EXPECTED:
        assert ref == EXPECTED[case.__name__]
    assert port == ref


# ----------------------------------------------------- the port's own rules
@pytest.fixture
def port_serve():
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        yield ray_tpu_torch.serve
    finally:
        try:
            ray_tpu_torch.serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def test_proxy_that_cannot_bind_raises(port_serve):
    """A proxy whose port is taken raises from serve.start; it does not
    come up on another port."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        with pytest.raises(OSError):
            port_serve.start(http_options={"port": taken.getsockname()[1]})
    from ray_tpu_torch.serve.api import _state

    assert _state["proxy"] is None


def test_replica_that_fails_to_construct_fails_run(port_serve):
    """serve.run raises at once with the replica's own error, instead of
    waiting out its timeout while the reconciler retries."""

    @port_serve.deployment
    class Broken:
        def __init__(self):
            raise ValueError("no weights here")

        def __call__(self):
            return 1

    start = time.monotonic()
    with pytest.raises(RuntimeError, match="no weights here"):
        port_serve.run(Broken.bind(), name="broken", route_prefix=None)
    assert time.monotonic() - start < 30


def test_gpu_deployment_is_infeasible_without_a_gpu(port_serve):
    """ray_actor_options={"num_gpus": 1} cannot be placed on a host that
    registers no GPU; a deployment that asks for none is served there."""

    @port_serve.deployment(ray_actor_options={"num_gpus": 1})
    def on_gpu():
        return "gpu"

    with pytest.raises(RuntimeError, match="Infeasible"):
        port_serve.run(on_gpu.bind(), name="gpu_app", route_prefix=None)

    @port_serve.deployment
    def on_cpu():
        return "cpu"

    handle = port_serve.run(on_cpu.bind(), name="cpu_app", route_prefix=None)
    assert handle.remote().result(timeout_s=10) == "cpu"


def test_http_keep_alive_serves_requests_on_one_connection(port_serve):
    port_serve.start(http_options={"port": 0})

    @port_serve.deployment
    class Echo:
        async def __call__(self, request):
            return {"n": int(request.query_params["n"])}

    port_serve.run(Echo.bind(), name="ka", route_prefix="/ka")
    conn = http.client.HTTPConnection(*_host_port(ray_tpu_torch), timeout=10)
    try:
        for n in range(3):
            conn.request("GET", f"/ka?n={n}")
            resp = conn.getresponse()
            assert json.loads(resp.read()) == {"n": n}
            assert not resp.will_close
    finally:
        conn.close()


def test_bound_arguments_are_passed_by_reference(port_serve):
    """Weights bound into a deployment reach the replica as the same
    objects: the thread tier copies nothing."""
    import torch

    weights = {"w": torch.ones(3)}

    @port_serve.deployment
    class Holder:
        def __init__(self, params):
            self.params = params

        def __call__(self):
            return self.params

    handle = port_serve.run(Holder.bind(weights), name="ref", route_prefix=None)
    got = handle.remote().result(timeout_s=10)
    assert got is weights and got["w"] is weights["w"]


def test_version_hashes_tensors_by_identity():
    import torch

    from ray_tpu_torch.serve.deployment_state import DeploymentInfo

    a = torch.ones(2)

    def info(t):
        return DeploymentInfo(name="d", app_name="app", deployment_def=object,
                              init_kwargs={"params": {"w": t}})

    assert info(a).version() == info(a).version()
    assert info(a).version() != info(torch.ones(2)).version()


def test_http_request_framing(port_serve):
    """Bodies sent chunked and with ``Expect: 100-continue`` reach the
    replica whole; a malformed request or an over-long line gets a 400 and
    the connection closes."""
    port_serve.start(http_options={"port": 0})

    @port_serve.deployment
    class Echo:
        async def __call__(self, request):
            return {"body": (await request.body()).decode()}

    port_serve.run(Echo.bind(), name="frame", route_prefix="/frame")
    host, port = _host_port(ray_tpu_torch)

    def raw(data):
        with socket.create_connection((host, port), timeout=10) as sock:
            sock.sendall(data)
            out = b""
            while chunk := sock.recv(65536):
                out += chunk
        head, _, body = out.partition(b"\r\n\r\n")
        return head.split(b"\r\n")[0], body

    assert raw(b"POST /frame HTTP/1.1\r\nTransfer-Encoding: chunked\r\n"
               b"Connection: close\r\n\r\n3\r\nabc\r\n2;x=1\r\nde\r\n"
               b"0\r\n\r\n") == (b"HTTP/1.1 200 OK", b'{"body": "abcde"}')
    status, body = raw(b"POST /frame HTTP/1.1\r\nContent-Length: 2\r\n"
                       b"Expect: 100-continue\r\nConnection: close\r\n\r\nhi")
    assert status == b"HTTP/1.1 100 Continue"
    assert body.endswith(b'{"body": "hi"}')
    assert raw(b"NONSENSE\r\n\r\n")[0] == b"HTTP/1.1 400 Bad Request"
    assert raw(b"POST /frame HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
               b"-5\r\n")[0] == b"HTTP/1.1 400 Bad Request"
    assert raw(b"GET /" + b"a" * 70000 + b" HTTP/1.1\r\n\r\n")[0] == \
        b"HTTP/1.1 400 Bad Request"
    # HTTP/1.0 without keep-alive: answered in 1.0, and the server closes.
    assert raw(b"GET /frame HTTP/1.0\r\n\r\n") == (b"HTTP/1.0 200 OK",
                                                   b'{"body": ""}')


def test_abandoned_stream_is_cancelled_off_the_finalizer(port_serve):
    """A stream its consumer drops is cancelled by the reaper thread, not
    in the finalizer: collected inside the router's own lock, it neither
    deadlocks nor keeps the replica's slot."""
    import gc

    @port_serve.deployment
    class Endless:
        def tokens(self):
            i = 0
            while True:
                time.sleep(0.01)
                yield i
                i += 1

    handle = port_serve.run(Endless.bind(), name="abandon", route_prefix=None)
    gen = handle.options(method_name="tokens", stream=True).remote()
    assert next(gen) == 0
    router = handle._get_router()
    done = threading.Event()

    def drop_inside_the_router_lock():
        nonlocal gen
        with router._scheduler._lock:
            del gen
            gc.collect()
        done.set()

    t = threading.Thread(target=drop_inside_the_router_lock, daemon=True)
    t.start()
    assert done.wait(10), "the finalizer waited for the router's lock"
    assert _wait_for_zero_ongoing(ray_tpu_torch, handle) == 0
    deadline = time.time() + 10
    while router._scheduler.total_inflight() and time.time() < deadline:
        time.sleep(0.05)
    assert router._scheduler.total_inflight() == 0


def test_stream_dropped_before_its_first_pull_is_cancelled(port_serve):
    """A stream abandoned before any pull resolved its id still ends on
    the replica: the reaper resolves the id and cancels."""
    import gc

    @port_serve.deployment
    class Endless:
        def tokens(self):
            i = 0
            while True:
                time.sleep(0.01)
                yield i
                i += 1

    handle = port_serve.run(Endless.bind(), name="early", route_prefix=None)
    gen = handle.options(method_name="tokens", stream=True).remote()
    del gen
    gc.collect()
    assert _wait_for_zero_ongoing(ray_tpu_torch, handle) == 0


def test_client_that_leaves_before_the_first_item_frees_the_replica(port_serve):
    port_serve.start(http_options={"port": 0})

    @port_serve.deployment
    class Slow:
        def __call__(self, request):
            time.sleep(1.0)
            i = 0
            while True:
                yield str(i)
                time.sleep(0.01)
                i += 1

    handle = port_serve.run(Slow.bind(), name="leave", route_prefix="/leave")
    with socket.create_connection(_host_port(ray_tpu_torch), timeout=10) as sock:
        sock.sendall(b"GET /leave HTTP/1.1\r\nHost: x\r\n\r\n")
        time.sleep(0.3)  # the proxy has opened the stream
    assert _wait_for_zero_ongoing(ray_tpu_torch, handle) == 0


def test_gpu_replicas_each_pin_their_own_card(monkeypatch):
    """Two one-GPU replicas on a host with two cards (torch's count faked
    here) are granted, and pin, different devices."""
    monkeypatch.setattr(ray_tpu_torch._private.device, "gpu_count", lambda: 2)
    fresh_init(ray_tpu_torch, num_cpus=4)
    serve = ray_tpu_torch.serve
    try:
        @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 1})
        class OnCard:
            def __init__(self):
                from ray_tpu_torch._private.device import granted_cuda_device

                self.device = str(granted_cuda_device())

            def __call__(self):
                return self.device

        handle = serve.run(OnCard.bind(), name="cards", route_prefix=None)
        assert handle.remote().result(timeout_s=10) in ("cuda:0", "cuda:1")
        scheduler = handle._get_router()._scheduler
        deadline = time.time() + 10
        while len(scheduler._replicas) < 2 and time.time() < deadline:
            time.sleep(0.05)
        with scheduler._lock:
            actors = [r["actor"] for r in scheduler._replicas]
        devices = ray_tpu_torch.get(
            [a.handle_request.remote("__call__") for a in actors], timeout=10)
        assert sorted(devices) == ["cuda:0", "cuda:1"]
        assert ray_tpu_torch.available_resources()["GPU"] == 0
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def test_serve_threads_end_with_the_runtime():
    """The proxy, the long-poll clients and the routers' metrics loops of
    a serve instance end once it and its runtime are shut down: none keeps
    polling a controller that is gone."""
    before = set(threading.enumerate())
    fresh_init(ray_tpu_torch, num_cpus=4)
    serve = ray_tpu_torch.serve
    try:
        serve.start(http_options={"port": 0})

        @serve.deployment
        def hello(request=None):
            return "hi"

        handle = serve.run(hello.bind(), name="threads", route_prefix="/t")
        assert handle.remote().result(timeout_s=10) == "hi"
        assert _http(ray_tpu_torch, "/t")[3] == b"hi"
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()

    def serve_threads():
        return [t.name for t in set(threading.enumerate()) - before
                if t.name.startswith(("serve-long-poll", "serve-router",
                                      "serve-http-proxy"))]

    deadline = time.time() + 15  # a long poll in flight ends within 10 s
    while serve_threads() and time.time() < deadline:
        time.sleep(0.1)
    assert serve_threads() == []
