"""Running a parity case in a test process shared with other tests.

pytest runs many test files in one process, and a test that ran earlier
(some of the reference's own tests end with their runtime or serve
instance still up) must neither make ``init`` raise nor leave a second
runtime running beside the one a parity test starts: ``fresh_init`` ends
both packages' serve instances and runtimes first.

``gc_paused`` holds the cyclic garbage collector off while a case runs.
The reference's ``ObjectRef`` finalizer releases its count with a blocking
acquire of the refcount table's lock, and the collector can run that
finalizer inside the same lock's critical section on the same thread
(Python 3.12 collects at any eval-breaker check): the thread then waits
for itself and the test process hangs. The port's finalizer only tries the
lock (tests/test_torch_runtime.py holds it to that); the reference is not
edited, so the parity cases, which run it far more than its own tests do,
pause the collector around the reference's half and collect once it is
over. The port's half runs with the collector on.
"""

import contextlib
import gc
import importlib
import queue
import threading

import ray_tpu
import ray_tpu_torch


def fresh_init(pkg, **kwargs):
    for other in (ray_tpu, ray_tpu_torch):
        importlib.import_module(other.__name__ + ".serve").shutdown()
        other.shutdown()
    return pkg.init(**kwargs)


def bounded(fn, timeout):
    """``fn()``, run on a daemon thread so that a call that never returns
    (a stream that never ends, a wedged worker) fails its test after
    ``timeout`` seconds with ``queue.Empty`` instead of stalling the run."""
    out: "queue.Queue" = queue.Queue()

    def run():
        try:
            out.put((True, fn()))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out.put((False, e))

    threading.Thread(target=run, daemon=True).start()
    ok, value = out.get(timeout=timeout)
    if not ok:
        raise value
    return value


@contextlib.contextmanager
def gc_paused():
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
        gc.collect()
