"""The port's util shims (``ray_tpu_torch.util.actor_pool``,
``util.multiprocessing``, ``util.joblib``) against the reference's: the
ActorPool, Pool and joblib cases of tests/test_util_shims.py on both
packages, then more of each API.

Each case runs on the reference, then on the port, each in a runtime of its
own (tests/_torch_train_parity.py), and returns what it observed: ordered
results, errors by class, chunk sizes, callback calls. The two observations
must be equal exactly.
"""

import importlib
import os
import subprocess
import sys

import pytest

import ray_tpu_torch
from _torch_train_parity import assert_same, both, raises

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _parity(case, *args):
    ref, port = both(case, *args)
    assert_same(ref, port, atol=0)
    return port


def _doubler(pkg):
    @pkg.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    return Doubler


def _sq(x):
    return x * x


def _addt(a, b):
    return a + b


def _boom(x):
    raise ValueError(f"no {x}")


# ------------------------------------------- tests/test_util_shims.py:27, 33
def _pool_map_ordered(pkg):
    ActorPool = _sub(pkg, "util.actor_pool").ActorPool
    Doubler = _doubler(pkg)
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    return list(pool.map(lambda a, v: a.double.remote(v), [1, 2, 3, 4, 5]))


def test_actor_pool_map_ordered():
    assert _parity(_pool_map_ordered) == [2, 4, 6, 8, 10]


def _pool_map_unordered_and_submit(pkg):
    ActorPool = _sub(pkg, "util.actor_pool").ActorPool
    Doubler = _doubler(pkg)
    pool = ActorPool([Doubler.remote() for _ in range(3)])
    out = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                    list(range(7))))
    # submit/get_next_unordered with more work than actors (pending queue)
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    got = sorted([pool.get_next_unordered(timeout=10),
                  pool.get_next_unordered(timeout=10)])
    return out, got, pool.has_next()


def test_actor_pool_map_unordered_and_submit():
    assert _parity(_pool_map_unordered_and_submit) == [
        [0, 2, 4, 6, 8, 10, 12], [20, 40], False]


def _pool_queue_push_pop(pkg):
    """More actors' work than actors, ``get_next`` with a timeout, an
    exhausted pool, ``pop_idle``/``push``/``has_free``, and work queued on
    a pool with no actor left."""
    import threading

    ActorPool = _sub(pkg, "util.actor_pool").ActorPool

    @pkg.remote
    class Gated:
        def __init__(self, gate):
            self.gate = gate

        def run(self, x):
            if x == "wait":
                self.gate.wait(10)
            return x

    gate = threading.Event()
    a, b = Gated.remote(gate), Gated.remote(gate)
    pool = ActorPool([a, b])
    obs = {"free_at_start": pool.has_free()}
    for v in ("wait", 1, 2):  # two dispatched, one queued
        pool.submit(lambda actor, v: actor.run.remote(v), v)
    obs["free_when_busy"] = pool.has_free()
    obs["timeout"] = raises(lambda: pool.get_next(timeout=0.2))
    gate.set()
    obs["ordered"] = [pool.get_next(timeout=10) for _ in range(3)]
    obs["exhausted"] = raises(pool.get_next)
    obs["exhausted_unordered"] = raises(pool.get_next_unordered)
    popped = [pool.pop_idle(), pool.pop_idle()]
    obs["popped"] = sorted(p is not None for p in popped)
    obs["pop_empty"] = pool.pop_idle() is None
    obs["free_after_pop"] = pool.has_free()
    pool.submit(lambda actor, v: actor.run.remote(v), 3)
    obs["stranded"] = raises(pool.get_next)
    obs["stranded_unordered"] = raises(pool.get_next_unordered)
    pool.push(popped[0])  # the queued value goes to the pushed actor
    obs["after_push"] = [pool.get_next(timeout=10), pool.has_free()]
    return obs


def test_actor_pool_queue_timeout_push_and_pop_idle():
    assert _parity(_pool_queue_push_pop) == {
        "free_at_start": True, "free_when_busy": False,
        "timeout": "TimeoutError", "ordered": ["wait", 1, 2],
        "exhausted": "StopIteration", "exhausted_unordered": "StopIteration",
        "popped": [True, True], "pop_empty": True, "free_after_pop": False,
        "stranded": "RuntimeError", "stranded_unordered": "RuntimeError",
        "after_push": [3, True]}


def _pool_task_error_frees_its_actor(pkg):
    ActorPool = _sub(pkg, "util.actor_pool").ActorPool

    @pkg.remote
    class Picky:
        def run(self, x):
            if x < 0:
                raise ValueError(x)
            return x

    pool = ActorPool([Picky.remote()])
    pool.submit(lambda a, v: a.run.remote(v), -1)
    pool.submit(lambda a, v: a.run.remote(v), 5)
    return raises(pool.get_next) is not None, pool.get_next(timeout=10)


def test_actor_pool_task_error_returns_its_actor():
    assert _parity(_pool_task_error_frees_its_actor) == [True, 5]


# ------------------------------------------------ tests/test_util_shims.py:105
def _multiprocessing_pool(pkg):
    Pool = _sub(pkg, "util.multiprocessing").Pool
    with Pool(processes=2) as pool:
        obs = [pool.map(_sq, range(10)),
               pool.starmap(_addt, [(1, 2), (3, 4)]),
               list(pool.imap(_sq, [2, 3])),
               pool.apply_async(_addt, (5, 6)).get(timeout=30),
               pool.apply(_sq, (9,))]
    obs.append(raises(lambda: pool.map(_sq, [1])))  # closed
    return obs


def test_multiprocessing_pool():
    assert _parity(_multiprocessing_pool) == [
        [x * x for x in range(10)], [3, 7], [4, 9], 11, 81, "ValueError"]


_INIT_CALLS = []


def _record_init(tag):
    _INIT_CALLS.append(tag)


def _multiprocessing_pool_more(pkg):
    """Chunk sizes, the once-per-pool initializer, imap over an iterator,
    async results with callbacks, and a closed pool's errors."""
    mp = _sub(pkg, "util.multiprocessing")
    del _INIT_CALLS[:]
    pool = mp.Pool(processes=2, initializer=_record_init, initargs=("a",))
    obs = {
        "chunks_default": [len(c) for c in pool._chunks(range(20), None)],
        "chunks_3": [len(c) for c in pool._chunks(iter(range(10)), 3)],
        "map_chunked": pool.map(_sq, range(12), chunksize=5),
        "imap_iter": list(pool.imap(_sq, iter(range(7)), chunksize=2)),
        "imap_unordered": sorted(pool.imap_unordered(_sq, range(5))),
    }
    obs["init_calls"] = list(_INIT_CALLS)
    got = []
    res = pool.map_async(_sq, [1, 2, 3], callback=got.append)
    obs["async"] = [res.get(timeout=30), res.ready(), res.successful()]
    res.get(timeout=30)  # a second get fires no second callback
    obs["callback"] = got
    errs = []
    bad = pool.map_async(_boom, [1], error_callback=lambda e: errs.append(
        type(e).__name__))
    obs["bad"] = [raises(lambda: bad.get(timeout=30)), bad.successful(),
                  errs]
    one = []
    res = pool.starmap_async(_addt, [(1, 1), (2, 2)], callback=one.append)
    obs["starmap_async"] = [res.get(timeout=30), list(one)]
    failed = []
    res = pool.apply_async(_boom, (2,), error_callback=lambda e: failed.append(
        str(e).splitlines()[0]))
    obs["apply_error"] = [raises(lambda: res.get(timeout=30)), failed]
    obs["join_open"] = raises(pool.join)
    pool.close()
    obs["join_closed"] = raises(pool.join)
    obs["closed"] = [raises(lambda: pool.imap(_sq, [1]).__next__()),
                     raises(lambda: pool.apply_async(_sq, (1,)))]
    pool.terminate()
    return obs


def test_multiprocessing_pool_chunks_initializer_and_callbacks():
    obs = _parity(_multiprocessing_pool_more)
    assert obs["chunks_default"] == [8, 8, 4]
    assert obs["init_calls"] == ["a"]
    assert obs["callback"] == [[1, 4, 9]]
    assert obs["bad"][0] is not None and obs["bad"][2] != []


# ------------------------------------------------ tests/test_util_shims.py:119
def _joblib_backend(pkg):
    import joblib

    _sub(pkg, "util.joblib").register_ray()
    with joblib.parallel_backend("ray_tpu", n_jobs=2):
        return joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(8))


def test_joblib_backend():
    pytest.importorskip("joblib")
    assert _parity(_joblib_backend) == [i * i for i in range(8)]


def test_joblib_module_imports_without_joblib():
    """The card's machine has no joblib: the module imports there and its
    backend class takes the placeholder bases; here joblib is blocked."""
    code = """
import sys
sys.modules["joblib"] = None
import ray_tpu_torch.util.joblib as j
cls = j.RayTpuBackend
print([b.__name__ for b in cls.__mro__[1:]])
print(cls().effective_n_jobs(1))
print("joblib" in sys.modules and sys.modules["joblib"] is not None)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:3] == [
        "['_RayTpuBackendMethods', '_PoolManagerMixin', "
        "'_AutoBatchingMixin', 'object']", "1", "False"]


def test_joblib_backend_class_has_joblibs_bases():
    pytest.importorskip("joblib")
    from joblib._parallel_backends import ParallelBackendBase

    from ray_tpu_torch.util import joblib as j

    assert issubclass(j.RayTpuBackend, ParallelBackendBase)
    assert j.RayTpuBackend is j._backend_class()
    assert ray_tpu_torch.util.joblib.RayTpuBackend.__name__ == "RayTpuBackend"
