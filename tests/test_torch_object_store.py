"""The port's object store (``ray_tpu_torch/_private/object_store.py``, its
value tier and its serialized tier on the shared-memory arena) against the
reference's, on the cases of tests/test_object_store.py: the reference
count freeing an object (:12), a nested ref keeping one alive (:22),
spilling and restoring under a small capacity (:33), a zero-copy view
outliving a free (:79), and a freed id put again serving the new value
(:98).

Each case runs on the reference, then on the port, each in a runtime of its
own (tests/_torch_train_parity.py); the observations must be equal, arrays
exactly. Then the port's own: the store's shutdown unlinks the arena and
removes the spill files, and a process task's result is kept as its wire
form in the arena until a get deserializes it.
"""

import gc
import importlib
import os

import numpy as np

import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both


def _rt(pkg):
    return importlib.import_module(pkg.__name__ + "._private.runtime")


def _parity(case):
    ref, port = both(case)
    assert_same(ref, port, atol=0)
    return port


# ------------------------------------------------ tests/test_object_store.py:12
def _refcount_free_on_release(pkg):
    store = _rt(pkg).get_runtime().store
    ref = pkg.put(np.zeros(1000))
    oid = ref.id
    held = store.contains(oid)
    del ref
    gc.collect()
    return [held, store.contains(oid)]


def test_refcount_free_on_release():
    assert _parity(_refcount_free_on_release) == [True, False]


# ------------------------------------------------ tests/test_object_store.py:22
def _refs_alive_while_copied(pkg):
    store = _rt(pkg).get_runtime().store
    ref = pkg.put("value")
    ref2 = pkg.get(pkg.put([ref]))[0]  # a nested ref, serialized and back
    oid = ref.id
    del ref
    gc.collect()
    return [store.contains(oid), pkg.get(ref2)]


def test_refs_alive_while_copied():
    assert _parity(_refs_alive_while_copied) == [True, "value"]


# ------------------------------------------------ tests/test_object_store.py:33
def _spilling_and_restore(pkg):
    store = _rt(pkg).get_runtime().store
    old = store.capacity_bytes
    store.capacity_bytes = 1 << 20  # 1 MiB: every second wire form spills
    try:
        refs = []
        for i in range(8):
            ref = pkg.put(np.full(100_000, i, dtype=np.float64))  # 800 KB
            store.get_serialized(ref.id)  # its wire form into the arena
            store.evict_value(ref.id)
            refs.append(ref)
        spilled = store.stats["spills"]
        values = [pkg.get(r) for r in refs]
        return [spilled, store.stats["restores"],
                [bool((v == np.full(100_000, i)).all())
                 for i, v in enumerate(values)]]
    finally:
        store.capacity_bytes = old


def test_spilling_and_restore():
    spilled, restores, equal = _parity(_spilling_and_restore)
    assert spilled > 0 and restores > 0 and all(equal)


# ------------------------------------------------ tests/test_object_store.py:79
def _zero_copy_view_survives_free(pkg):
    store = _rt(pkg).get_runtime().store
    arr = np.random.default_rng(0).random(200_000)
    expected = arr.copy()
    ref = pkg.put(arr)
    store.get_serialized(ref.id)   # the wire form into the arena
    store.evict_value(ref.id)      # drop the value
    out = pkg.get(ref)             # deserialized zero-copy from the arena
    del ref
    gc.collect()                   # count 0 -> free
    later = [pkg.put(np.full(200_000, float(i))) for i in range(5)]
    for r in later:                # blocks a recycled one would reuse
        store.get_serialized(r.id)
    return [bool((out == expected).all()), out.shape]


def test_zero_copy_view_survives_free():
    assert _parity(_zero_copy_view_survives_free) == [True, [200_000]]


# ------------------------------------------------ tests/test_object_store.py:98
def _free_then_reput(pkg):
    rt = _rt(pkg).get_runtime()
    ids = importlib.import_module(pkg.__name__ + "._private.ids")
    ser = importlib.import_module(pkg.__name__ + "._private.serialization")
    store = rt.store
    oid = ids.ObjectID.from_random()
    store.put(oid, np.arange(4, dtype=np.float64))
    store.get_serialized(oid)
    store.get(oid)
    # An exported view: free() keeps the arena block instead of deleting.
    store._serialized_view(oid, store._entries[oid], export=True)
    store.free(oid)
    store.put(oid, np.arange(8, dtype=np.float64) * 3)
    out = store.get(oid)
    again = ser.deserialize_flat(memoryview(bytes(store.get_serialized(oid))))
    return [out.shape, float(out[1]), again.shape]


def test_free_then_reput_serves_the_new_value():
    assert _parity(_free_then_reput) == [[8], 3.0, [8]]


# ------------------------------------------------------------ the port's own
def test_shutdown_unlinks_the_arena_and_the_spill_files():
    rt = fresh_init(ray_tpu_torch, num_cpus=2)
    store = rt.store
    path = store.arena_path
    assert os.path.basename(path).startswith(f"torch_plasma_{os.getpid()}_")
    store.capacity_bytes = 1 << 20
    refs = [ray_tpu_torch.put(np.full(100_000, i, dtype=np.float64))
            for i in range(4)]
    for r in refs:
        store.get_serialized(r.id)
    spills = [e.spill_path for e in store._entries.values() if e.spill_path]
    assert spills and all(os.path.exists(p) for p in spills)
    ray_tpu_torch.shutdown()
    assert not os.path.exists(path)
    assert not any(os.path.exists(p) for p in spills)


def test_process_result_is_kept_as_its_wire_form():
    rt = fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        @ray_tpu_torch.remote(isolation="process")
        def make(n):
            return np.arange(n, dtype=np.float32)

        ref = make.remote(300_000)  # 1.2 MB: above the handoff threshold
        assert rt.store.wait_ready(ref.id, 60)
        entry = rt.store._entries[ref.id]
        assert (entry.in_plasma, entry.has_value) == (True, False)
        assert rt.store.size_of(ref.id) == entry.size > 1_200_000
        out = ray_tpu_torch.get(ref, timeout=60)
        assert entry.has_value and np.array_equal(
            out, np.arange(300_000, dtype=np.float32))
        assert [o["in_plasma"] for o in rt.store.object_summaries()
                if o["object_id"] == str(ref.id)] == [True]
    finally:
        ray_tpu_torch.shutdown()
