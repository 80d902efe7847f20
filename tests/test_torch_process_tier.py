"""The port's process tier (ray_tpu_torch) against the reference (ray_tpu) on
the cases of tests/test_process_tier.py, the process cases of
tests/test_core_tasks.py and the runtime-env cases of
tests/test_ops_infra.py, and the port's own rules for it.

Each parity case is one body run against both packages, one after the
other (the two runtimes never run at once): it returns what it observed,
and the port's observation must equal the reference's. The bodies that run
inside a worker are defined inside the case, so both packages send them by
value. Every ``get`` has a timeout, so a hang fails its case.

``process_task_large_args_via_arena`` (tests/test_core_tasks.py:204) sends
a 2 MB array through the object store's shared-memory arena both ways and
counts the arena's objects after five more calls. Left out:
``test_actor_pool_survives_raising_task`` (``util/actor_pool.py`` is not
ported). The reference's generator-error case is racy (its ``_fail_task`` writes the error over the
first item); the port's is held to the contract instead.
"""

import multiprocessing
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused

T = 60  # seconds any one get may wait
CASE_S = 240  # seconds one package's half of a parity case may take


def _raises(fn):
    """The class name of what ``fn`` raises (None if it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return type(e).__name__
    return None


def _counter(pkg):
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

        def pid(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    return pkg.remote(Counter)


def _until_alive(pkg, fn, deadline_s=30):
    """``fn()`` once the actor is back (ActorDiedError while it restarts)."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return fn()
        except pkg.exceptions.ActorDiedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


# ----------------------------------------------------------- process actors
def process_actor_state_and_isolation(pkg):
    a = _counter(pkg).options(isolation="process").remote(10)
    return [pkg.get(a.incr.remote(), timeout=T),
            pkg.get(a.incr.remote(5), timeout=T),
            pkg.get(a.pid.remote(), timeout=T) != os.getpid()]


def process_actor_restart_on_crash(pkg):
    a = _counter(pkg).options(isolation="process", max_restarts=1).remote(0)
    pid1 = pkg.get(a.pid.remote(), timeout=T)
    died = _raises(lambda: pkg.get(a.die.remote(), timeout=T))
    pid2 = _until_alive(pkg, lambda: pkg.get(a.pid.remote(), timeout=T))
    return [died, pid2 != pid1, pkg.get(a.incr.remote(), timeout=T)]


def process_actor_no_restart_stays_dead(pkg):
    a = _counter(pkg).options(isolation="process", max_restarts=0).remote()
    return [_raises(lambda: pkg.get(a.die.remote(), timeout=T)),
            _raises(lambda: pkg.get(a.incr.remote(), timeout=T))]


def actor_runtime_env_implies_process(pkg):
    class EnvReader:
        def read(self, name):
            return os.environ.get(name), os.getpid() != DRIVER

    DRIVER = os.getpid()
    a = pkg.remote(EnvReader).options(
        runtime_env={"env_vars": {"RAY_TPU_TEST_MARKER": "proc-actor"}},
    ).remote()
    return [list(pkg.get(a.read.remote("RAY_TPU_TEST_MARKER"), timeout=T)),
            os.environ.get("RAY_TPU_TEST_MARKER")]


def async_actor_rejects_process_isolation(pkg):
    class AsyncThing:
        async def go(self):
            return 1

    try:
        pkg.remote(AsyncThing).options(isolation="process").remote()
    except ValueError as e:
        return ["ValueError", "async actors" in str(e)]
    return None


def exit_actor_from_process_actor(pkg):
    class Quitter:
        def quit(self):
            pkg.exit_actor()

        def ping(self):
            return "pong"

    a = pkg.remote(Quitter).options(isolation="process",
                                    max_restarts=3).remote()
    return [pkg.get(a.ping.remote(), timeout=T),
            pkg.get(a.quit.remote(), timeout=T),
            _raises(lambda: pkg.get(a.ping.remote(), timeout=T))]


def process_actor_concurrent_calls(pkg):
    class Sleeper:
        def nap(self, s):
            time.sleep(s)
            return os.getpid()

    a = pkg.remote(Sleeper).options(isolation="process",
                                    max_concurrency=3).remote()
    pkg.get(a.nap.remote(0.01), timeout=T)  # absorb the spawn
    t0 = time.monotonic()
    pids = set(pkg.get([a.nap.remote(0.8) for _ in range(3)], timeout=T))
    wall = time.monotonic() - t0
    return [len(pids), os.getpid() not in pids, wall < 2.0]


# ------------------------------------------------------- the nested API
def nested_task_submission(pkg):
    def nested():
        @pkg.remote
        def sq(x):
            return x * x

        refs = [sq.remote(i) for i in range(4)]
        ready, rest = pkg.wait(refs, num_returns=4, timeout=30)
        assert not rest
        return sum(pkg.get(refs))

    f = pkg.remote(nested).options(isolation="process")
    return pkg.get(f.remote(), timeout=T)


def nested_put_get(pkg):
    def put_get():
        ref = pkg.put({"payload": list(range(100))})
        return pkg.get(ref)["payload"][-1]

    return pkg.get(pkg.remote(put_get).options(isolation="process").remote(),
                   timeout=T)


def nested_actor_call(pkg):
    def call_named():
        h = pkg.get_actor("shared-counter")
        return pkg.get(h.incr.remote(7))

    _counter(pkg).options(name="shared-counter").remote(100)
    f = pkg.remote(call_named).options(isolation="process")
    first = pkg.get(f.remote(), timeout=T)
    h = pkg.get_actor("shared-counter")
    return [first, pkg.get(h.incr.remote(), timeout=T)]


def nested_generator_submission(pkg):
    def drain():
        @pkg.remote
        def squares(n):
            for i in range(n):
                yield i * i

        return [pkg.get(r) for r in squares.remote(4)]

    return pkg.get(pkg.remote(drain).options(isolation="process").remote(),
                   timeout=T)


def internal_kv_is_cluster_global(pkg):
    kv = __import__(pkg.__name__ + ".experimental.internal_kv",
                    fromlist=["_"])

    def from_worker():
        kv._internal_kv_put("worker-key", "from-worker", namespace="kvtest")
        seen = kv._internal_kv_get("driver-key", namespace="kvtest")
        existed = kv._internal_kv_put("driver-key", "overwrite",
                                      namespace="kvtest")
        keys = sorted(kv._internal_kv_list("", namespace="kvtest"))
        return seen, existed, keys

    kv._internal_kv_put("driver-key", "from-driver", namespace="kvtest")
    f = pkg.remote(from_worker).options(isolation="process")
    seen, existed, keys = pkg.get(f.remote(), timeout=T)
    out = [seen, existed, keys,
           kv._internal_kv_get("worker-key", namespace="kvtest"),
           kv._internal_kv_get("driver-key", namespace="kvtest")]
    for k in keys:
        kv._internal_kv_del(k, namespace="kvtest")
    return out


# ------------------------------------------------------------- streaming
def generator_task_on_process_worker(pkg):
    def gen(n):
        for i in range(n):
            yield {"i": i, "pid": os.getpid()}

    vals = [pkg.get(r, timeout=T) for r in
            pkg.remote(gen).options(isolation="process").remote(4)]
    return [[v["i"] for v in vals], all(v["pid"] != os.getpid() for v in vals)]


def generator_task_with_runtime_env(pkg):
    def gen():
        for _ in range(2):
            yield os.environ.get("GEN_ENV_MARK")

    g = pkg.remote(gen).options(
        runtime_env={"env_vars": {"GEN_ENV_MARK": "on"}}).remote()
    return [pkg.get(r, timeout=T) for r in g]


def generator_method_on_process_actor(pkg):
    class Streamer:
        def __init__(self):
            self.base = 100

        def items(self, n):
            for i in range(n):
                yield self.base + i

    a = pkg.remote(Streamer).options(isolation="process").remote()
    return [pkg.get(r, timeout=T) for r in a.items.remote(3)]


# ------------------------------------------- tests/test_core_tasks.py cases
def process_isolation_task(pkg):
    @pkg.remote(isolation="process")
    def worker_pid():
        return os.getpid()

    return pkg.get(worker_pid.remote(), timeout=T) != os.getpid()


def retry_on_worker_crash(pkg):
    @pkg.remote(isolation="process", max_retries=2)
    def flaky(path):
        # Crash the worker process on the first attempt only.
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "recovered"

    marker = tempfile.mktemp()
    try:
        return pkg.get(flaky.remote(marker), timeout=T)
    finally:
        if os.path.exists(marker):
            os.unlink(marker)


# ------------------------------------------------------ runtime envs
def _wheel_cache(root):
    from _make_wheels import make_wheel

    d = os.path.join(root, "wheels")
    os.makedirs(d, exist_ok=True)
    make_wheel(d, "tinypkg-a", "1.0", "__version__ = '1.0'\n")
    make_wheel(d, "tinypkg-b", "2.0",
               "import tinypkg_a\n__version__ = '2.0'\n",
               requires=["tinypkg-a"])
    return d


def _offline_env(installer):
    def case(pkg):
        def read_versions():
            import tinypkg_a
            import tinypkg_b

            return tinypkg_a.__version__, tinypkg_b.__version__

        with tempfile.TemporaryDirectory() as root:
            f = pkg.remote(read_versions).options(
                runtime_env={installer: ["tinypkg-b"],
                             "config": {"pip_find_links": _wheel_cache(root)}})
            versions = tuple(pkg.get(f.remote(), timeout=120))
        return [versions, _raises(lambda: __import__("tinypkg_a"))]

    case.__name__ = f"offline_{installer}_runtime_env"
    return case


def runtime_env_env_vars_applied_in_worker(pkg):
    def read_env():
        return os.environ.get("MY_RT_ENV"), os.getpid()

    val, pid = pkg.get(pkg.remote(read_env).options(
        runtime_env={"env_vars": {"MY_RT_ENV": "hello"}}).remote(), timeout=T)
    return [val, pid != os.getpid(), os.environ.get("MY_RT_ENV")]


def runtime_env_worker_reuse_keyed_by_env(pkg):
    def pid_and_env():
        return os.getpid(), os.environ.get("K")

    f = pkg.remote(pid_and_env)
    a1, a2, b1 = [pkg.get(f.options(runtime_env={"env_vars": {"K": k}})
                          .remote(), timeout=T) for k in "aab"]
    return [[a1[1], a2[1], b1[1]], a1[0] == a2[0], b1[0] != a1[0]]


def runtime_env_working_dir_and_py_modules(pkg):
    def use_env():
        import mypkg

        with open("data.txt") as f:  # cwd is the staged working_dir
            return mypkg.VALUE, f.read()

    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "mypkg"))
        with open(os.path.join(root, "mypkg", "__init__.py"), "w") as f:
            f.write("VALUE = 42\n")
        os.makedirs(os.path.join(root, "wd"))
        with open(os.path.join(root, "wd", "data.txt"), "w") as f:
            f.write("payload")
        return list(pkg.get(pkg.remote(use_env).options(runtime_env={
            "working_dir": os.path.join(root, "wd"),
            "py_modules": [root]}).remote(), timeout=T))


def runtime_env_validation(pkg):
    env_mod = __import__(pkg.__name__ + "._private.runtime_env",
                         fromlist=["_"])
    RuntimeEnv = env_mod.RuntimeEnv
    out = [_raises(lambda: RuntimeEnv(env_vars={"A": 1})),
           _raises(lambda: RuntimeEnv(bogus_field=True)),
           _raises(lambda: RuntimeEnv(pip=["requests"]).stage()),
           _raises(lambda: RuntimeEnv(pip=["a"], uv=["b"])),
           _raises(lambda: RuntimeEnv(pip=[1, 2]))]
    env = RuntimeEnv(env_vars={"A": "1"})
    return out + [env.env_key() == RuntimeEnv(env_vars={"A": "1"}).env_key(),
                  env.env_key() != RuntimeEnv(env_vars={"A": "2"}).env_key()]


def pip_env_network_installs_stay_gated(pkg):
    env_mod = __import__(pkg.__name__ + "._private.runtime_env",
                         fromlist=["_"])
    try:
        env_mod.RuntimeEnv(pip=["requests"]).stage()
    except RuntimeError as e:
        return ["RuntimeError", "offline" in str(e)]
    return None


def process_task_large_args_via_arena(pkg):
    """Args and results above the handoff threshold ride the arena, and
    each call's handoff objects are freed (tests/test_core_tasks.py:204)."""
    import numpy as np

    rt = __import__(pkg.__name__ + "._private.runtime",
                    fromlist=["_"]).get_runtime()
    arr = np.random.default_rng(0).random((500, 500))  # 2 MB

    def double(x):
        return x * 2.0

    f = pkg.remote(double).options(isolation="process")
    first = bool((pkg.get(f.remote(arr), timeout=T) == arr * 2.0).all())
    objs = rt.store.plasma.usage()[2]
    for _ in range(5):
        pkg.get(f.remote(arr), timeout=T)
    return [first, rt.store.arena_path is not None,
            rt.store.plasma.usage()[2] <= objs + 2]


def conda_still_rejected(pkg):
    env_mod = __import__(pkg.__name__ + "._private.runtime_env",
                         fromlist=["_"])
    try:
        env_mod.RuntimeEnv(conda={"dependencies": ["x"]})
    except RuntimeError as e:
        return ["RuntimeError", "conda" in str(e)]
    return None


CASES = [
    (process_actor_state_and_isolation, [11, 16, True]),
    (process_actor_restart_on_crash, ["ActorDiedError", True, 1]),
    (process_actor_no_restart_stays_dead,
     ["ActorDiedError", "ActorDiedError"]),
    (actor_runtime_env_implies_process, [["proc-actor", True], None]),
    (async_actor_rejects_process_isolation, ["ValueError", True]),
    (exit_actor_from_process_actor, ["pong", None, "ActorDiedError"]),
    (process_actor_concurrent_calls, [1, True, True]),
    (nested_task_submission, 0 + 1 + 4 + 9),
    (nested_put_get, 99),
    (nested_actor_call, [107, 108]),
    (nested_generator_submission, [0, 1, 4, 9]),
    (internal_kv_is_cluster_global,
     [b"from-driver", True, [b"driver-key", b"worker-key"], b"from-worker",
      b"overwrite"]),
    (generator_task_on_process_worker, [[0, 1, 2, 3], True]),
    (generator_task_with_runtime_env, ["on", "on"]),
    (generator_method_on_process_actor, [100, 101, 102]),
    (process_isolation_task, True),
    (retry_on_worker_crash, "recovered"),
    (_offline_env("pip"), [("1.0", "2.0"), "ModuleNotFoundError"]),
    (_offline_env("uv"), [("1.0", "2.0"), "ModuleNotFoundError"]),
    (runtime_env_env_vars_applied_in_worker, ["hello", True, None]),
    (runtime_env_worker_reuse_keyed_by_env, [["a", "a", "b"], True, True]),
    (runtime_env_working_dir_and_py_modules, [42, "payload"]),
    (runtime_env_validation, ["ValueError", "ValueError", "RuntimeError",
                              "ValueError", "ValueError", True, True]),
    (pip_env_network_installs_stay_gated, ["RuntimeError", True]),
    (conda_still_rejected, ["RuntimeError", True]),
    (process_task_large_args_via_arena, [True, True, True]),
]


def _run(pkg, case):
    fresh_init(pkg, num_cpus=4)
    try:
        return bounded(lambda: case(pkg), CASE_S)
    finally:
        pkg.shutdown()


@pytest.mark.parametrize("case,expected", CASES,
                         ids=[c.__name__ for c, _ in CASES])
def test_port_process_tier_matches_reference(case, expected):
    with gc_paused():
        ref = _run(ray_tpu, case)
    port = _run(ray_tpu_torch, case)
    assert ref == expected
    assert port == ref


def test_pip_env_content_keyed_cache(tmp_path):
    """Same requirements and wheel dir -> the same venv, built once (the
    reference's uri_cache.py role)."""
    from ray_tpu_torch._private.runtime_env import RuntimeEnv

    wheels = _wheel_cache(str(tmp_path))
    p1 = RuntimeEnv(pip=["tinypkg-a"],
                    config={"pip_find_links": wheels}).stage()
    t0 = time.monotonic()
    p2 = RuntimeEnv(pip=["tinypkg-a"],
                    config={"pip_find_links": wheels}).stage()
    assert p1["venv_dir"] == p2["venv_dir"]
    assert time.monotonic() - t0 < 1.0  # a cache hit, no rebuild
    assert os.path.isfile(p1["venv_python"])
    assert os.path.isdir(p1["venv_site"])


# ----------------------------------------------------- the port's own rules
@pytest.fixture(scope="module")
def port():
    """One runtime for the port's own cases, so they reuse pooled workers;
    re-initialised if another test module's case shut it down."""
    yield _ensure_port
    ray_tpu_torch.shutdown()


def _ensure_port(**kwargs):
    if not ray_tpu_torch.is_initialized() or kwargs:
        fresh_init(ray_tpu_torch, **{"num_cpus": 4, **kwargs})
    return ray_tpu_torch


def test_generator_items_outlive_a_process_generators_error(port):
    """Items yielded before a process generator fails come back, every one,
    and the error is raised at its index (the reference's _fail_task writes
    it over item 0, so its own case races)."""
    pkg = port()

    def bad(n):
        for i in range(n):
            yield i
        raise RuntimeError("stream blew up")

    for n in (1, 3):
        it = iter(pkg.remote(bad).options(isolation="process").remote(n))
        refs = bounded(lambda: [next(it) for _ in range(n)], T)
        with pytest.raises(pkg.exceptions.TaskError, match="stream blew up"):
            bounded(lambda: next(it), T)
        assert pkg.get(refs, timeout=T) == list(range(n))


def test_gpu_leases_name_the_workers_cards(port, monkeypatch):
    """A worker leased with GPUs sees exactly the granted cards
    (CUDA_VISIBLE_DEVICES), get_gpu_ids() in it returns the lease's ids as
    the driver numbers them, and granted_cuda_device() maps them to the
    worker's own index; a worker started without cards is never leased
    for a GPU task. Two cards are faked (device.gpu_count patched), so the
    case runs without a GPU."""
    from ray_tpu_torch._private import device

    monkeypatch.setattr(device, "gpu_count", lambda: 2)
    pkg = port(num_gpus=2)

    def where():
        import ray_tpu_torch
        from ray_tpu_torch._private.device import granted_cuda_device

        gpu = ray_tpu_torch.get_gpu_ids()
        return (os.getpid(), gpu, os.environ["CUDA_VISIBLE_DEVICES"],
                str(granted_cuda_device()) if gpu else None)

    cpu_pid = pkg.get(pkg.remote(where).options(isolation="process")
                      .remote(), timeout=T)[0]

    class Holder:
        def where(self):
            return where()

    first = pkg.remote(Holder).options(isolation="process",
                                       num_gpus=1).remote()
    pid0, ids0, vis0, dev0 = pkg.get(first.where.remote(), timeout=T)
    # Card 0 is held by the actor: a one-card task gets card 1.
    pid1, ids1, vis1, dev1 = pkg.get(
        pkg.remote(where).options(isolation="process", num_gpus=1).remote(),
        timeout=T)
    assert (ids0, vis0, dev0) == ([0], "0", "cuda:0")
    assert (ids1, vis1, dev1) == ([1], "1", "cuda:0")
    assert len({cpu_pid, pid0, pid1}) == 3
    # The card-less worker is idle again, and still not leased for a GPU.
    _, _, vis, _ = pkg.get(pkg.remote(where).options(
        isolation="process", num_gpus=0.5).remote(), timeout=T)
    assert vis == "1"
    pkg.shutdown()


def test_visible_devices_follow_the_drivers_own_list(monkeypatch):
    from ray_tpu_torch._private.process_pool import _visible_devices

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert _visible_devices((1, 0)) == "1,0"
    assert _visible_devices(()) == ""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, 5")
    assert _visible_devices((1,)) == "5"


def test_shutdown_leaves_no_worker_process():
    """Every worker, idle, leased to a running task or hosting an actor,
    ends and is reaped by shutdown()."""
    from ray_tpu_torch._private.stack_profiler import worker_pids

    pkg = _ensure_port(num_cpus=4)

    @pkg.remote(isolation="process")
    def busy():
        time.sleep(60)

    def pid():
        return os.getpid()

    class Host:
        def pid(self):
            return os.getpid()

    busy.remote()  # holds its worker until shutdown
    actor = pkg.remote(Host).options(isolation="process").remote()
    hosted = pkg.get(actor.pid.remote(), timeout=T)
    # Released to the idle pool (an actor created now would take it).
    idle = pkg.get(pkg.remote(pid).options(isolation="process").remote(),
                   timeout=T)
    deadline = time.monotonic() + T
    while len(worker_pids()) < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    pids = set(worker_pids())
    assert {idle, hosted} <= pids and len(pids) == 3
    t0 = time.monotonic()
    pkg.shutdown()
    assert time.monotonic() - t0 < 10
    live = {p.pid for p in multiprocessing.active_children()}
    assert not pids & live
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_stack_dumps_of_process_workers(port):
    """The driver's threads and a SIGUSR1 faulthandler dump of a busy
    worker (the reference's test_stack_dumps_driver_and_process_workers)."""
    from ray_tpu_torch._private import stack_profiler

    pkg = port()

    @pkg.remote(isolation="process")
    def busy():
        time.sleep(3)
        return "done"

    ref = busy.remote()
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        pids = stack_profiler.worker_pids()
        if pids and all(os.path.exists(os.path.join(
                stack_profiler.dump_dir(), f"{p}.txt")) for p in pids):
            break
        time.sleep(0.05)
    stacks = stack_profiler.collect_all_stacks()
    assert "MainThread" in stacks["driver"]
    dump = "\n".join(str(v) for v in stacks["process_workers"].values())
    assert "Thread" in dump or "File" in dump, dump[:200]
    text = stack_profiler.format_stacks(stacks)
    assert "driver thread" in text and "process worker pid=" in text
    assert pkg.get(ref, timeout=T) == "done"


def test_worker_logs_captured_and_tailed(port):
    """Worker prints land in per-pid session log files and come back to the
    driver prefixed (worker pid=N) (the reference's
    test_worker_logs_captured_and_tailed)."""
    from ray_tpu_torch._private.log_monitor import LogMonitor, log_dir

    pkg = port()

    def chatty():
        print("hello from the worker")
        print("warning line", file=sys.stderr)
        return os.getpid()

    pid = pkg.get(pkg.remote(chatty).options(isolation="process").remote(),
                  timeout=T)
    out_path = os.path.join(log_dir(), f"worker-{pid}.out")
    err_path = os.path.join(log_dir(), f"worker-{pid}.err")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not (
            os.path.exists(out_path)
            and "hello from the worker" in open(out_path).read()):
        time.sleep(0.05)
    assert "warning line" in open(err_path).read()
    lines = []
    LogMonitor(emit=lines.append).poll_once()
    joined = "\n".join(lines)
    assert f"(worker pid={pid}) hello from the worker" in joined
    assert f"(worker pid={pid}, stderr) warning line" in joined


def test_worker_logs_and_dumps_follow_each_runtimes_session_dir(
        tmp_path, monkeypatch):
    """Two runtimes one after the other, each with its own session dir:
    each one's worker writes its log and registers its stack-dump file
    under its own session, not under the first one exported."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    for var in ("RAY_TPU_TORCH_WORKER_LOG_DIR",
                "RAY_TPU_TORCH_STACK_DUMP_DIR"):
        monkeypatch.delenv(var, raising=False)  # restored after the case
    monkeypatch.setattr(GLOBAL_CONFIG, "session_dir", GLOBAL_CONFIG.session_dir)

    def chatty(tag):
        print(tag)
        return os.getpid()

    try:
        for tag in ("first", "second"):
            GLOBAL_CONFIG.session_dir = str(tmp_path / tag)
            pkg = _ensure_port(num_cpus=2)
            pid = pkg.get(pkg.remote(chatty).options(isolation="process")
                          .remote(tag), timeout=T)
            out = tmp_path / tag / "logs" / f"worker-{pid}.out"
            dump = tmp_path / tag / "stack_dumps" / f"{pid}.txt"
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not (
                    out.exists() and tag in out.read_text()):
                time.sleep(0.05)
            assert out.read_text().split() == [tag]
            assert dump.exists()
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------- by-value serialization
_SCRIPT = textwrap.dedent('''
    import json, os, sys
    sys.modules["cloudpickle"] = None
    sys.modules["psutil"] = None
    import ray_tpu_torch as rt

    SCALE = 3

    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    def make_counter():
        count = [0]

        def even(n):
            return True if n == 0 else odd(n - 1)

        def odd(n):
            return False if n == 0 else even(n - 1)

        def bump(k):
            count[0] += k * SCALE
            return count[0], even(count[0])

        return bump

    def local_class():
        class Point:
            dims = 2

            def __init__(self, x, y):
                self.x, self.y = x, y

            @staticmethod
            def origin():
                return Point(0, 0)

            @classmethod
            def rank(cls):
                return cls.dims

            @property
            def norm1(self):
                return abs(self.x) + abs(self.y)

            def shifted(self, d):
                return type(self)(self.x + d, self.y + d)

        return Point

    def traced(fn):
        def wrapper(*a):
            return ("traced", fn(*a))
        return wrapper

    @rt.remote(isolation="process")
    @traced
    def decorated(x):
        return fact(x)

    # No main guard: a worker never runs this module again.
    rt.init(num_cpus=2)
    try:
        Point = local_class()
        lam = lambda v: v * SCALE
        bump = make_counter()

        @rt.remote(isolation="process")
        def run_all(p):
            q = p.shifted(1)
            return {"fact": fact(6), "lam": lam(5), "bump": bump(2),
                    "point": [q.x, q.y, q.norm1, Point.rank(),
                              Point.origin().norm1],
                    "pid": os.getpid(),
                    "blocked": "cloudpickle" in sys.modules
                               or "psutil" in sys.modules}

        out = rt.get(run_all.remote(Point(1, 2)), timeout=120)
        actor = rt.remote(Point).options(isolation="process").remote(3, 4)
        out["actor"] = [rt.get(actor.shifted.remote(2), timeout=120).norm1,
                        rt.get(actor.rank.remote(), timeout=120)]
        out["decorated"] = rt.get(decorated.remote(5), timeout=120)
        out["driver_pid"] = os.getpid()
        print(json.dumps(out))
    finally:
        rt.shutdown()
''')


@pytest.mark.parametrize("launch", ["path", "module"])
def test_process_tier_runs_without_cloudpickle(tmp_path, launch):
    """A driver with no main guard, run from its file or with ``python -m``,
    with cloudpickle and psutil blocked, runs a closure over __main__'s
    globals, a lambda, recursive and mutually recursive functions, a
    decorated @remote body and a locally defined class (as an argument and
    as a process actor) in worker processes, which load neither module
    either and never run the driver again (spawn would, by its file or by
    its module name, and the driver's init() would then fail the worker)."""
    import json

    script = tmp_path / "tier_driver.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path),
         str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    argv = {"path": [str(script)], "module": ["-m", "tier_driver"]}[launch]
    out = subprocess.run([sys.executable] + argv, env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["pid"] != res["driver_pid"]
    assert res["blocked"] is False
    assert res["fact"] == 720 and res["lam"] == 15
    assert res["bump"] == [6, True]
    assert res["point"] == [2, 3, 5, 2, 0]
    assert res["actor"] == [11, 2]
    assert res["decorated"] == ["traced", 120]


def _make_objects():
    scale = 3

    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    def even(n):
        return True if n == 0 else odd(n - 1)

    def odd(n):
        return False if n == 0 else even(n - 1)

    class Point:
        dims = 2

        def __init__(self, x, y):
            self.x, self.y = x, y

        @staticmethod
        def origin():
            return Point(0, 0)

        @classmethod
        def rank(cls):
            return cls.dims

        @property
        def norm1(self):
            return abs(self.x) + abs(self.y)

        def __repr__(self):
            return f"{type(self).__name__}({self.x}, {self.y}){super().__repr__()[:0]}"

    @ray_tpu_torch.remote
    def remote_body(x):
        return fact(x) * scale

    return fact, even, (lambda v: v * scale), Point, remote_body


def test_serialization_round_trips_by_value():
    """Functions and classes that cannot be imported by name go by value
    (recursive and mutually recursive closures, a lambda, a local class with
    static/class methods, a property and super(), a decorated @remote
    body); importable ones and modules go by reference; ObjectRefs in a
    value are captured."""
    import pickle

    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.object_ref import ObjectRef

    fact, even, lam, Point, remote_body = pickle.loads(
        serialization.dumps(_make_objects()))
    assert fact(6) == 720 and even(10) and not even(7) and lam(5) == 15
    p = Point(2, -3)
    assert (p.norm1, Point.rank(), Point.origin().norm1) == (5, 2, 0)
    assert repr(p) == "Point(2, -3)" and type(p) is Point
    assert remote_body._function(4) == 72
    assert pickle.loads(serialization.dumps(os.path.join)) is os.path.join
    assert pickle.loads(serialization.dumps(os)) is os
    assert pickle.loads(serialization.dumps(fresh_init)) is fresh_init
    ref = ObjectRef("00" * 12 + ":0", _add_ref=False)
    sobj = serialization.serialize({"a": [ref]})
    assert sobj.contained_refs == [ref]
    assert serialization.deserialize_flat(sobj.to_bytes())["a"][0] == ref


@pytest.mark.cuda
def test_cuda_tensor_crosses_as_a_host_copy(port):
    """A CUDA tensor sent to a process worker arrives as a CPU tensor (its
    device index would name another card there), and one sent back does
    too; the worker moves it to its own card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pkg = port(num_gpus=torch.cuda.device_count())

    def on_card(t):
        from ray_tpu_torch._private.device import granted_cuda_device

        arrived = t.device.type
        return arrived, (t.to(granted_cuda_device()) * 2)

    x = torch.arange(6.0, device="cuda")
    arrived, back = pkg.get(pkg.remote(on_card).options(
        isolation="process", num_gpus=1).remote(x), timeout=T)
    assert arrived == "cpu" and back.device.type == "cpu"
    assert torch.equal(back, (x * 2).cpu())
    pkg.shutdown()


def test_pipe_messages_keep_connection_framing():
    """``process_pool.recv_bytes`` reads what ``Connection.send_bytes``
    writes: empty, short (header and payload in one write), long (header
    then payload) and several in a row, then EOF at a message boundary."""
    from ray_tpu_torch._private.process_pool import recv_bytes

    a, b = multiprocessing.Pipe(duplex=False)
    msgs = [b"", b"x" * 10, os.urandom(1 << 20), b"tail"]

    def send():
        for m in msgs:
            b.send_bytes(m)
        b.close()

    import threading

    t = threading.Thread(target=send)
    t.start()
    got = [bytes(recv_bytes(a)) for _ in msgs]
    with pytest.raises(EOFError):
        recv_bytes(a)
    t.join(timeout=10)
    assert got == msgs
