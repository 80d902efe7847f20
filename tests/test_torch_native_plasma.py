"""The port's shared-memory arena (``ray_tpu_torch/native/plasma.py`` over
its own ``plasma.cc``) against the reference's (``ray_tpu/native/plasma.py``)
on the 17 cases of tests/test_native_plasma.py, then the port's own rules.

Each parity case is one sequence of operations, with the same ids, sizes
and capacities, applied to a fresh arena of each package. The case logs
every return value (bytes, views as bytes, booleans, refcounts, the class
name of what a call raised), ``usage()`` and which objects eviction left;
the two logs must be equal. The cases that cross processes spawn a child
that attaches the arena of the package under test.

The port's own: a ``close()`` during a blocking ``get`` on another thread
makes that get raise and crashes nothing (in a child process, so a crash
fails the case rather than the test run); a seal after a waiting process
was killed still wakes the arena's getters; the capacity is clamped to the
free space of the arena's filesystem; the port's sweep of dead arenas never
touches the reference's ``tpu_plasma_*`` files.
"""

import importlib
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import time

import pytest

MODULES = ("ray_tpu.native.plasma", "ray_tpu_torch.native.plasma")
MiB = 1 << 20


def _raised(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return type(e).__name__
    return bytes(out) if isinstance(out, memoryview) else out


# ----------------------------------------------------------------- cases
def put_get_roundtrip(P, store, log):
    store.put_bytes("a", b"hello world")
    log += [store.contains("a"), store.get_bytes("a")]


def zero_copy_view_and_refcount(P, store, log):
    store.put_bytes("a", b"x" * 1000)
    log.append(store.refcount("a"))
    v = store.get("a")
    log += [store.refcount("a"), bytes(v[:3])]
    v.release()
    store.release("a")
    log.append(store.refcount("a"))


def create_seal_visibility(P, store, log):
    buf = store.create("a", 4)
    log += [store.get("a", timeout=0), store.contains("a")]
    buf[:] = b"abcd"
    buf.release()
    store.seal("a")
    log.append(store.get_bytes("a"))


def duplicate_create_rejected(P, store, log):
    store.put_bytes("a", b"1")
    log.append(_raised(lambda: store.create("a", 1)))


def delete_and_reuse(P, store, log):
    store.put_bytes("a", b"z" * 100)
    store.release("a")
    log += [store.delete("a"), store.contains("a"), store.usage()[0],
            store.usage()[2]]
    store.put_bytes("a", b"y" * 100)
    log.append(store.get_bytes("a"))


def delete_refuses_referenced(P, store, log):
    store.put_bytes("a", b"z")
    log.append(store.delete("a"))
    store.release("a")
    log.append(store.delete("a"))


def lru_eviction_on_pressure(P, store, log):
    for i in range(6):
        store.put_bytes(f"obj{i}", b"b" * MiB)
        store.release(f"obj{i}")
    store.put_bytes("big", b"c" * (3 * MiB))
    log += [store.contains("big")] + [store.contains(f"obj{i}")
                                      for i in range(6)]


def pinned_objects_survive_eviction(P, store, log):
    store.put_bytes("pinned", b"p" * MiB)
    for i in range(8):
        store.put_bytes(f"f{i}", b"b" * MiB)
        store.release(f"f{i}")
    log += [store.contains("pinned"), store.get_bytes("pinned") == b"p" * MiB]
    log += [store.contains(f"f{i}") for i in range(8)]


def oom_when_nothing_evictable(P, store, log):
    store.put_bytes("a", b"b" * (4 * MiB))
    log.append(_raised(lambda: store.create("b", 6 * MiB)))


def allocator_coalescing(P, store, log):
    for k, c in (("a", b"1"), ("b", b"2"), ("c", b"3")):
        store.put_bytes(k, c * (2 * MiB))
    for k in ("a", "b"):
        store.release(k)
        log.append(store.delete(k))
    store.put_bytes("d", b"4" * (3 * MiB))
    log += [store.get_bytes("d") == b"4" * (3 * MiB),
            store.get_bytes("c") == b"3" * (2 * MiB)]


def unseal_mutation_channel_pattern(P, store, log):
    buf = store.create("ch", 4)
    buf[:] = b"aaaa"
    store.seal("ch")
    log.append(store.get_bytes("ch"))
    store.unseal("ch")
    log.append(store.get("ch", timeout=0))
    buf[:] = b"bbbb"
    store.seal("ch")
    log.append(store.get_bytes("ch"))
    buf.release()


def usage_accounting(P, store, log):
    used0, cap, objs0 = store.usage()
    log += [used0, objs0, cap > 0]
    store.put_bytes("a", b"x" * 1234)
    log.append(store.usage()[::2])


def _child_attach(module, path, q):
    P = importlib.import_module(module)
    c = P.PlasmaClient(path, create=False)
    data = c.get_bytes("from_parent", timeout=10)
    c.put_bytes("from_child", (data or b"") + b"/child")
    q.put("done")
    c.close()


def cross_process_attach(P, store, log):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_child_attach, args=(P.__name__, store.path, q))
    p.start()
    # Sealed after the child starts, so its get() takes the blocking path.
    store.put_bytes("from_parent", b"parent")
    log.append(q.get(timeout=60))
    p.join(timeout=10)
    log.append(store.get_bytes("from_child", timeout=10))


def _child_crash_holding_data(module, path):
    P = importlib.import_module(module)
    c = P.PlasmaClient(path, create=False)
    c.get("from_parent", timeout=10)  # holds a reference
    os._exit(1)


def store_survives_client_crash(P, store, log):
    store.put_bytes("from_parent", b"parent")
    p = mp.get_context("spawn").Process(
        target=_child_crash_holding_data, args=(P.__name__, store.path))
    p.start()
    p.join(timeout=60)
    store.put_bytes("after", b"ok")
    log += [p.exitcode, store.get_bytes("after"),
            store.refcount("from_parent")]


def many_small_objects(P, store, log):
    for i in range(300):
        store.put_bytes(f"k{i}", f"v{i}".encode())
    log.append(all(store.get_bytes(f"k{i}") == f"v{i}".encode()
                   for i in range(300)))
    deleted = []
    for i in range(300):
        store.release(f"k{i}")
        deleted.append(store.delete(f"k{i}"))
    log.append(all(deleted))
    for i in range(300):
        store.put_bytes(f"k{i}", b"again")
    log.append(store.usage()[2])


def unseal_requires_sole_ownership(P, store, log):
    store.put_bytes("own", b"data")
    view = store.get("own", timeout=0)
    log.append(_raised(lambda: store.unseal("own")))
    view.release()
    store.release("own")
    store.unseal("own")
    store.seal("own")
    log.append(store.get_bytes("own"))


def lru_eviction_order(P, store, log):
    for i in range(4):
        store.put_bytes(f"o{i}", bytes(512 * 1024))
        store.release(f"o{i}")
    v = store.get("o0", timeout=0)
    v.release()
    store.release("o0")
    log.append(store.evict(600 * 1024))
    log += [store.contains(f"o{i}") for i in range(4)]


def closed_client_raises_not_crashes(P, store, log):
    path = store.path + "-2"
    c = P.PlasmaClient(path, capacity=MiB, create=True, max_entries=64)
    c.put_bytes("x", b"abc")
    c.close(unlink=True)
    log += [_raised(lambda: c.get("x", timeout=0)),
            _raised(lambda: c.put_bytes("y", b"def")), os.path.exists(path)]


CASES = [put_get_roundtrip, zero_copy_view_and_refcount,
         create_seal_visibility, duplicate_create_rejected, delete_and_reuse,
         delete_refuses_referenced, lru_eviction_on_pressure,
         pinned_objects_survive_eviction, oom_when_nothing_evictable,
         allocator_coalescing, unseal_mutation_channel_pattern,
         usage_accounting, cross_process_attach, store_survives_client_crash,
         many_small_objects, unseal_requires_sole_ownership,
         lru_eviction_order, closed_client_raises_not_crashes]


def _observe(module, case, tmp_path):
    P = importlib.import_module(module)
    store = P.PlasmaClient(str(tmp_path / module), capacity=8 * MiB,
                           create=True, max_entries=512)
    log = []
    try:
        case(P, store, log)
        log.append(("usage", store.usage()))
    finally:
        store.close(unlink=True)
    return log


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_port_arena_matches_reference(case, tmp_path):
    ref = _observe(MODULES[0], case, tmp_path)
    port = _observe(MODULES[1], case, tmp_path)
    assert port == ref


# ---------------------------------------------------------- the port's own
def test_close_during_a_blocking_get_raises_and_does_not_crash(tmp_path):
    """Five threads block in ``get`` of absent objects, with and without a
    timeout; ``close()`` on the main thread wakes them: each get raises
    ``ConnectionError``, close returns, and a call after it raises too.
    The reference frees the handle under such a get (its close does not
    wait), which can crash the process."""
    script = textwrap.dedent(f"""
        import threading, time
        from ray_tpu_torch.native.plasma import PlasmaClient
        c = PlasmaClient({str(tmp_path / "arena")!r}, capacity=1 << 20,
                         create=True, max_entries=64)
        got = []

        def wait(timeout):
            try:
                got.append(c.get("never", timeout=timeout))
            except ConnectionError as e:
                got.append(type(e).__name__)

        ts = [threading.Thread(target=wait, args=(t,))
              for t in (None, None, 30.0, 30.0, 60.0)]
        for t in ts:
            t.start()
        time.sleep(0.5)
        t0 = time.monotonic()
        c.close(unlink=True)
        took = time.monotonic() - t0
        for t in ts:
            t.join(5)
        try:
            c.contains("never")
            after = None
        except ConnectionError as e:
            after = type(e).__name__
        print(sorted(got), any(t.is_alive() for t in ts), took < 2.0, after)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == (
        "['ConnectionError', 'ConnectionError', 'ConnectionError', "
        "'ConnectionError', 'ConnectionError'] False True ConnectionError")


def _child_waits(path):
    from ray_tpu_torch.native.plasma import PlasmaClient

    PlasmaClient(path, create=False).get("never", timeout=0.05)
    c = PlasmaClient(path, create=False)
    while True:
        c.get("never", timeout=0.01)


def test_seal_wakes_getters_after_a_waiting_process_was_killed(tmp_path):
    """Getters wait on a futex word, not a process-shared condvar: a worker
    killed while it waits (its loop in a timed get when its pool
    terminates it) leaves nothing behind, and the next seal still wakes a
    getter at once."""
    import threading

    from ray_tpu_torch.native.plasma import PlasmaClient

    store = PlasmaClient(str(tmp_path / "arena"), capacity=MiB, create=True,
                         max_entries=64)
    try:
        ctx = mp.get_context("spawn")
        for _ in range(3):
            p = ctx.Process(target=_child_waits, args=(store.path,))
            p.start()
            time.sleep(1.0)
            p.kill()
            p.join(10)
        got = []
        t = threading.Thread(target=lambda: got.append(
            store.get_bytes("late", timeout=20)))
        t.start()
        time.sleep(0.2)
        t0 = time.monotonic()
        store.put_bytes("late", b"ok")
        t.join(20)
        assert got == [b"ok"] and time.monotonic() - t0 < 5
    finally:
        store.close(unlink=True)


def test_capacity_is_clamped_to_the_filesystems_free_space(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    from ray_tpu_torch.native import plasma

    monkeypatch.setattr(plasma, "free_bytes", lambda path: 3 * MiB + 123)
    with caplog.at_level("WARNING", logger=plasma.__name__):
        c = plasma.PlasmaClient(str(tmp_path / "arena"), capacity=64 * MiB,
                                create=True, max_entries=64)
    try:
        assert c.capacity == 3 * MiB
        assert os.path.getsize(c.path) == 3 * MiB
        assert "clamped" in caplog.text
        # Below the free space nothing changes.
        assert plasma.clamp_capacity(c.path, MiB) == MiB
    finally:
        c.close(unlink=True)


def test_sweep_never_touches_the_references_arenas(tmp_path):
    """The port sweeps its own arenas of dead processes and nothing else:
    neither the reference's ``tpu_plasma_*`` files nor its own of a live
    process."""
    from ray_tpu_torch._private.object_store import _sweep_dead_arenas

    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    dead, live = p.pid, os.getpid()
    names = [f"tpu_plasma_{dead}_1_1", f"torch_plasma_{dead}_1_1",
             f"torch_plasma_{live}_1_1", "torch_plasma_x"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    _sweep_dead_arenas(roots=[str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"tpu_plasma_{dead}_1_1", f"torch_plasma_{live}_1_1",
         "torch_plasma_x"])
