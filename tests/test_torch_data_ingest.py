"""The port's streaming ingest (ray_tpu_torch.data.ingest) and its sample
ledger (ray_tpu_torch.train.elastic) against the reference on the cases of
tests/test_data_ingest.py that need neither a Trainer, a cluster, a
simulated preemption nor a JAX mesh.

Each case runs on both packages on the same inputs and what each observed
must be equal: window-shuffle permutations for a seed, claim order, rows
per epoch, ledger states, metric movements, the records of TFRecord byte
ranges and the rows read back. Where the reference moves batches to a JAX
device, the port's half moves them with ``device="cpu"`` (its
``DeviceBatchIterator`` on the card is held by tests/test_torch_cuda.py)
and both are reduced to numpy. The reference's slow bounded-memory case
runs here at a fifth of its rows.

Its two elastic cases (a node preempted mid-epoch, and a grow at an epoch
boundary; tests/test_data_ingest.py:742,765) end the file: they run on the
port alone, on a virtual cluster, with the reference's loop in torch, and
hold the same exactly-once audits and sums.
"""

import os
import threading
import time
from importlib import import_module

import numpy as np
import pytest

from _torch_data import both, raises


def _m(pkg, name):
    return import_module(f"{pkg.__name__}.{name}")


def _ingest(pkg):
    return _m(pkg, "data.ingest")


def _ledger(pkg):
    return _m(pkg, "train.elastic")


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _set_chaos(pkg, spec):
    _m(pkg, "_private.config").GLOBAL_CONFIG.testing_rpc_failure = spec
    _m(pkg, "_private.fault_injection").reset_injector()


# ----------------------------------------------------------- window shuffle
def shuffle_exactly_once_and_deterministic(pkg, data):
    ing = _ingest(pkg)
    out = list(ing.window_shuffle(iter(range(100)), 8, ing.epoch_rng(3, 0)))
    again = list(ing.window_shuffle(iter(range(100)), 8, ing.epoch_rng(3, 0)))
    return [out, out == again, sorted(out) == list(range(100))]


def shuffle_epoch_changes_order(pkg, data):
    ing = _ingest(pkg)
    return [list(ing.window_shuffle(iter(range(100)), 8, ing.epoch_rng(3, e)))
            for e in (0, 1)]


def shuffle_bounded_lookahead(pkg, data):
    ing = _ingest(pkg)
    out = list(ing.window_shuffle(iter(range(200)), 8, ing.epoch_rng(1, 0)))
    return [out, all(item <= 8 + k for k, item in enumerate(out))]


def shuffle_window_one_is_passthrough(pkg, data):
    ing = _ingest(pkg)
    return list(ing.window_shuffle(iter(range(50)), 1, ing.epoch_rng(1, 0)))


def shuffle_byte_cap_tightens_window(pkg, data):
    ing = _ingest(pkg)
    out = list(ing.window_shuffle(iter(range(60)), 32, ing.epoch_rng(5, 0),
                                  size_of=lambda _x: 10, max_bytes=50))
    return [out, all(item <= 32 + k for k, item in enumerate(out))]


# ------------------------------------------------- plan sharding, backpressure
def read_splits_per_task(pkg, data):
    ing = _ingest(pkg)
    ds = data.range(40, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 2})
    plans = ing.shard_plans(ds._op)
    Dataset = _m(pkg, "data.dataset").Dataset
    rows = [[v for b in Dataset(p).iter_batches(batch_size=None)
             for v in b["id"].tolist()] for p in plans]
    return [ing.shardable(ds._op), len(plans), rows]


def all_to_all_falls_back_to_single_shard(pkg, data):
    ing = _ingest(pkg)
    ds = data.range(40, parallelism=4).random_shuffle()
    return [ing.shardable(ds._op), len(ing.shard_plans(ds._op))]


def actor_compute_falls_back(pkg, data):
    ing = _ingest(pkg)

    class Add:
        def __call__(self, b):
            return {"id": b["id"] + 1}

    ds = data.range(40, parallelism=4).map_batches(Add, concurrency=1)
    return [ing.shardable(ds._op), len(ing.shard_plans(ds._op))]


def backpressure_is_lazy(pkg, data):
    ing = _ingest(pkg)
    block_from_batch = _m(pkg, "data.block").block_from_batch
    executed = []

    def make_task(i):
        def read():
            executed.append(i)
            return block_from_batch({"id": np.arange(8, dtype=np.int64) + 8 * i})

        return read

    Dataset = _m(pkg, "data.dataset").Dataset
    Read = _m(pkg, "data.plan").Read
    ds = Dataset(Read([make_task(i) for i in range(32)]))
    it = ing.StreamingIngest(ds, window_blocks=4, seed=0,
                             prefetch_batches=0).make_shard().iter_batches(
        batch_size=8)
    first = next(iter(it))
    return [first, 0 < len(executed) < 32]


# --------------------------------------------------- epochs and accounting
def epoch_exactly_once_and_reshuffled(pkg, data):
    ing = _ingest(pkg)
    ds = data.range(64, parallelism=8).map_batches(lambda b: b)
    st = ing.StreamingIngest(ds, window_blocks=4, seed=11)
    shard = st.make_shard()
    epochs = [[v for b in shard.iter_batches(batch_size=6)
               for v in b["id"].tolist()] for _ in range(2)]
    return [epochs, st.audit(0), st.audit(1), st.exhausted()]


def two_shards_partition_the_epoch(pkg, data):
    ing = _ingest(pkg)
    st = ing.StreamingIngest(data.range(64, parallelism=8), window_blocks=2,
                             seed=1)
    its = [iter(s.iter_batches(batch_size=4))
           for s in (st.make_shard(), st.make_shard())]
    got = [[], []]
    done = [False, False]
    while not all(done):
        for i in (0, 1):
            if not done[i]:
                batch = next(its[i], None)
                if batch is None:
                    done[i] = True
                else:
                    got[i].extend(batch["id"].tolist())
    return [sorted(got[0] + got[1]) == list(range(64)),
            not set(got[0]) & set(got[1])]


def reset_replays_from_scratch(pkg, data):
    ing = _ingest(pkg)
    st = ing.StreamingIngest(data.range(32, parallelism=4), window_blocks=2,
                             seed=2)
    first = [v for b in st.make_shard().iter_batches(batch_size=8)
             for v in b["id"].tolist()]
    st.reset()
    second = [v for b in st.make_shard().iter_batches(batch_size=8)
              for v in b["id"].tolist()]
    return [first, second]


def larger_than_budget_epoch_bounded_memory(pkg, data):
    ing = _ingest(pkg)
    budget = 1 << 20
    n = 250_000
    st = ing.StreamingIngest(data.range(n, parallelism=40), window_blocks=8,
                             window_bytes=budget, seed=3, prefetch_batches=2)
    count = sum(len(b["id"]) for b in st.make_shard().iter_batches(
        batch_size=4096))
    return [count, st.peak_window_bytes <= 3 * budget, st.audit(0)]


# -------------------------------------------------- cross-thread accounting
def shard_tracker_cross_thread_consistency(pkg, data):
    tracker_cls = _m(pkg, "data.ingest.ingest")._ShardTracker
    el = _ledger(pkg)
    n_shards, n_blocks = 8, 200
    led = el.SampleLedger(list(range(n_shards)))
    led.claim(n_shards, step=el.PROVISIONAL_STEP)
    tracker = tracker_cls(led)
    sem = threading.Semaphore(0)

    def pump():
        for pos in range(n_shards):
            for _ in range(n_blocks):
                tracker.entered(pos)
                sem.release()
            tracker.shard_produced(pos, n_blocks)

    def consume():
        for pos in range(n_shards):
            for _ in range(n_blocks):
                sem.acquire()
                tracker.block_done(pos)

    threads = [threading.Thread(target=pump), threading.Thread(target=consume)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return [led.trained_counts(), led.double_trained(), led.untrained(),
            tracker._blocks, tracker._produced]


def abandoned_epoch_releases_window_bytes(pkg, data):
    ing = _ingest(pkg)
    st = ing.StreamingIngest(data.range(256, parallelism=16), window_blocks=4,
                             seed=7, prefetch_batches=2)
    it = iter(st.make_shard().iter_batches(batch_size=8))
    got = [next(it), next(it)]
    resident = st.resident_window_bytes > 0
    it.close()
    deadline = time.monotonic() + 10
    while st.resident_window_bytes and time.monotonic() < deadline:
        time.sleep(0.02)
    return [got, resident, st.resident_window_bytes]


def finish_rolls_back_never_consumed_claims(pkg, data):
    ing = _ingest(pkg)
    st = ing.StreamingIngest(data.range(64, parallelism=8), window_blocks=2,
                             seed=5, prefetch_batches=2, seal_on_claim=False)
    it = iter(st.make_shard().iter_batches(batch_size=8))
    consumed = []
    for _ in range(2):
        consumed.extend(next(it)["id"].tolist())
    it.close()
    rolled_back = st.finish()
    audit = st.audit(0)
    whole = all(set(range(8 * s, 8 * s + 8)) <= set(consumed)
                for s in audit["trained_counts"])
    return [consumed, rolled_back >= 1, audit["double_trained"], whole]


# --------------------------------------------------------------- retagging
def retag_then_seal(pkg, data):
    el = _ledger(pkg)
    led = el.SampleLedger(list(range(4)))
    got = led.claim(2, step=el.PROVISIONAL_STEP)
    moved = led.retag(got, step=5)
    led.seal(4)
    before = led.trained_counts()
    led.seal(5)
    return [got, moved, before, led.trained_counts()]


def retag_none_seals_immediately(pkg, data):
    el = _ledger(pkg)
    led = el.SampleLedger(list(range(4)))
    got = led.claim(2, step=el.PROVISIONAL_STEP)
    return [led.retag(got, step=None), led.trained_counts()]


def retag_after_rollback_is_noop(pkg, data):
    el = _ledger(pkg)
    led = el.SampleLedger(list(range(4)))
    got = led.claim(2, step=el.PROVISIONAL_STEP)
    led.rollback(None)
    return [led.retag(got, step=7), led.remaining()]


def rollback_requeues_provisional_claims(pkg, data):
    el = _ledger(pkg)
    led = el.SampleLedger(list(range(6)))
    a = led.claim(3, step=el.PROVISIONAL_STEP)
    led.retag(a, step=2)
    led.claim(2, step=el.PROVISIONAL_STEP)
    led.seal(2)
    led.rollback(2)
    return [led.trained_counts(), led.remaining(), led.claim(3),
            led.exhausted()]


# ---------------------------------------------------------------- prefetch
def host_prefetcher_order_and_close(pkg, data):
    ing = _ingest(pkg)
    pf = ing.HostPrefetcher(({"i": np.asarray([i])} for i in range(20)),
                            depth=3)
    got = [int(b["i"][0]) for b in pf]
    pf.close()
    return got


def host_prefetcher_propagates_errors_in_order(pkg, data):
    ing = _ingest(pkg)

    def src():
        yield {"i": 0}
        yield {"i": 1}
        raise ValueError("pipeline exploded")

    it = iter(ing.HostPrefetcher(src(), depth=2))
    return [next(it)["i"], next(it)["i"], raises(lambda: next(it))]


def host_prefetcher_abandoned_consumer_unblocks_pump(pkg, data):
    ing = _ingest(pkg)
    produced = []

    def src():
        for i in range(1000):
            produced.append(i)
            yield {"i": i}

    pf = ing.HostPrefetcher(src(), depth=2)
    it = iter(pf)
    first = next(it)
    pf.close()
    time.sleep(0.3)
    n = len(produced)
    time.sleep(0.2)
    return [first, len(produced) == n, n < 1000]


def starved_seconds_counter_moves(pkg, data):
    ing = _ingest(pkg)
    metrics = _m(pkg, "data.ingest.metrics")
    before = metrics.STARVED_SECONDS.get()

    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield {"i": i}

    out = list(ing.HostPrefetcher(slow(), depth=2))
    return [out, metrics.STARVED_SECONDS.get() > before]


def _device_kw(pkg):
    return {"device": "cpu"} if pkg.__name__ == "ray_tpu_torch" else {}


def device_iterator_values_and_lookahead(pkg, data):
    ing = _ingest(pkg)
    pulled = []

    def src():
        for i in range(6):
            pulled.append(i)
            yield {"x": np.full(4, i, dtype=np.float32), "tag": f"b{i}"}

    it = iter(ing.DeviceBatchIterator(src(), **_device_kw(pkg)))
    first = next(it)
    lookahead = len(pulled)
    rest = list(it)
    return [lookahead, [[_np(b["x"]), b["tag"]] for b in [first] + rest]]


def device_iterator_with_sharding(pkg, data):
    """The reference places batches by a mesh sharding; the port raises
    until its DeviceMesh exists (ROADMAP.md, Queue 1 item 3)."""
    ing = _ingest(pkg)
    if pkg.__name__ == "ray_tpu":
        import jax

        from ray_tpu.parallel.mesh import MeshSpec, batch_sharding, make_mesh

        sharding = batch_sharding(make_mesh(MeshSpec.auto(len(jax.devices()))))
        src = ({"x": np.ones((8, 4), dtype=np.float32) * i} for i in range(3))
        out = list(ing.DeviceBatchIterator(src, sharding=sharding))
        return [len(out), out[1]["x"].sharding == sharding]
    return raises(lambda: ing.DeviceBatchIterator([], sharding=object()))


def ingest_device_path(pkg, data):
    ing = _ingest(pkg)
    ds = data.range(64, parallelism=8).map_batches(
        lambda b: {"x": b["id"].astype(np.float32)})
    shard = ing.StreamingIngest(ds, window_blocks=2, seed=4).make_shard()
    host = [b["x"] for b in shard.iter_batches(batch_size=8)]
    if pkg.__name__ == "ray_tpu":
        import jax

        dev = [np.asarray(b["x"]) for b in shard.iter_batches(
            batch_size=8, device_sharding=jax.devices()[0])]
    else:
        dev = [_np(b["x"]) for b in shard.iter_batches(batch_size=8,
                                                        device="cpu")]
    return [host, dev, float(sum(h.sum() for h in host)),
            float(sum(d.sum() for d in dev))]


# ---------------------------------------------------- offset-sharded readers
def _write_tfrecords(pkg, path, n=120):
    tf = _m(pkg, "data.tfrecords")
    recs = [tf.row_to_example({"i": i, "pad": b"x" * (17 * (i % 13))})
            for i in range(n)]
    tf.write_records(path, recs)
    return recs


def tfrecord_ranges_disjoint_and_complete(pkg, data, tmp):
    tf = _m(pkg, "data.tfrecords")
    path = str(tmp / "a.tfrecords")
    recs = _write_tfrecords(pkg, path, n=120)
    whole = list(tf.read_records(path))
    size = os.path.getsize(path)
    out = []
    for shards in (2, 4, 7):
        bounds = [size * i // shards for i in range(shards + 1)]
        parts = [list(tf.read_records_range(path, lo, hi))
                 for lo, hi in zip(bounds, bounds[1:])]
        out.append([len(p) for p in parts])
        out.append([r for p in parts for r in p] == whole)
    return [open(path, "rb").read(), whole == recs, out]


def tfrecord_range_arbitrary_offsets(pkg, data, tmp):
    tf = _m(pkg, "data.tfrecords")
    path = str(tmp / "b.tfrecords")
    _write_tfrecords(pkg, path, n=40)
    whole = list(tf.read_records(path))
    size = os.path.getsize(path)
    out = []
    for cut in (1, 13, size // 3, size // 2, size - 5, size):
        left = list(tf.read_records_range(path, 0, cut))
        right = list(tf.read_records_range(path, cut, size))
        out.append([len(left), left + right == whole])
    return out


def tfrecord_range_empty_cases(pkg, data, tmp):
    tf = _m(pkg, "data.tfrecords")
    path = str(tmp / "empty.tfrecords")
    tf.write_records(path, [])
    path2 = str(tmp / "c.tfrecords")
    _write_tfrecords(pkg, path2, n=3)
    size = os.path.getsize(path2)
    return [list(tf.read_records_range(path, 0, 10)),
            list(tf.read_records_range(path2, size, size + 10))]


def read_tfrecords_shards_per_file(pkg, data, tmp):
    path = str(tmp / "d.tfrecords")
    _write_tfrecords(pkg, path, n=100)
    ds = data.read_tfrecords(path, shards_per_file=4)
    rows = sorted(ds.iter_rows(), key=lambda r: r["i"])
    return [len(ds._op.read_tasks), rows]


def parquet_row_group_ranges(pkg, data, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp / "e.parquet")
    pq.write_table(pa.table({"i": np.arange(1000)}), path, row_group_size=100)
    ds = data.read_parquet(path, shards_per_file=5)
    ds2 = data.read_parquet(path, shards_per_file=64)
    return [len(ds._op.read_tasks), sorted(r["i"] for r in ds.iter_rows()),
            len(ds2._op.read_tasks), sorted(r["i"] for r in ds2.iter_rows())]


def parquet_zero_row_groups_not_dropped(pkg, data, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    readers = _m(pkg, "data.ingest.readers")
    path = str(tmp / "empty.parquet")
    pq.ParquetWriter(path, pa.schema([("i", pa.int64())])).close()
    tasks = readers.parquet_range_tasks(path, shards_per_file=4)
    block = tasks[0]()
    empty = list(data.read_parquet(path, shards_per_file=4).iter_rows())
    pq.write_table(pa.table({"i": np.arange(50)}),
                   str(tmp / "data.parquet"), row_group_size=10)
    st = _ingest(pkg).StreamingIngest(
        data.read_parquet(str(tmp), shards_per_file=4), window_blocks=2,
        seed=8, prefetch_batches=2)
    rows = sorted(int(v) for b in st.make_shard().iter_batches(batch_size=16)
                  for v in np.asarray(b["i"]).tolist())
    return [len(tasks), block.num_rows, list(block.schema.names), empty,
            rows, st.audit(0)]


def sharded_file_through_ingest(pkg, data, tmp):
    path = str(tmp / "f.tfrecords")
    _write_tfrecords(pkg, path, n=200)
    st = _ingest(pkg).StreamingIngest(
        data.read_tfrecords(path, shards_per_file=8), window_blocks=4, seed=6)
    rows = [int(v) for b in st.make_shard().iter_batches(batch_size=16)
            for v in np.asarray(b["i"]).tolist()]
    return [st.num_shards(), sorted(rows) == list(range(200))]


def expand_paths_sorted_and_deduped(pkg, data, tmp):
    import glob as glob_mod

    names = ["b.parquet", "a.parquet", "c.parquet"]
    for n in names:
        (tmp / n).write_bytes(b"")
    real_glob = glob_mod.glob
    mod = _m(pkg, "data")

    def scrambled(pattern, **kw):
        return list(reversed(sorted(real_glob(pattern, **kw))))

    mod._glob.glob = scrambled
    try:
        one = mod._expand_paths(str(tmp), ".parquet")
        two = mod._expand_paths([str(tmp), str(tmp / "*.parquet"),
                                 str(tmp / "a.parquet")], ".parquet")
    finally:
        mod._glob.glob = real_glob
    return [[os.path.basename(p) for p in one],
            [os.path.basename(p) for p in two]]


def chaos_fetch_failures_retry_no_torn_batch(pkg, data):
    metrics = _m(pkg, "data.ingest.metrics")
    retries_before = metrics.FETCH_RETRIES.get()
    _set_chaos(pkg, "data_ingest_fetch=0.5:3")
    try:
        ds = data.range(96, parallelism=12).map_batches(
            lambda b: {"x": b["id"].astype(np.float64)})
        st = _ingest(pkg).StreamingIngest(ds, window_blocks=4, seed=9,
                                          prefetch_batches=2)
        total, count = 0.0, 0
        for batch in st.make_shard().iter_batches(batch_size=8):
            total += float(np.sum(batch["x"]))
            count += len(batch["x"])
    finally:
        _set_chaos(pkg, "")
    return [count, total, metrics.FETCH_RETRIES.get() - retries_before >= 1,
            st.audit(0)]


@pytest.mark.parametrize("case", [
    shuffle_exactly_once_and_deterministic, shuffle_epoch_changes_order,
    shuffle_bounded_lookahead, shuffle_window_one_is_passthrough,
    shuffle_byte_cap_tightens_window, read_splits_per_task,
    all_to_all_falls_back_to_single_shard, actor_compute_falls_back,
    backpressure_is_lazy, epoch_exactly_once_and_reshuffled,
    two_shards_partition_the_epoch, reset_replays_from_scratch,
    larger_than_budget_epoch_bounded_memory,
    shard_tracker_cross_thread_consistency,
    abandoned_epoch_releases_window_bytes,
    finish_rolls_back_never_consumed_claims, retag_then_seal,
    retag_none_seals_immediately, retag_after_rollback_is_noop,
    rollback_requeues_provisional_claims, host_prefetcher_order_and_close,
    host_prefetcher_propagates_errors_in_order,
    host_prefetcher_abandoned_consumer_unblocks_pump,
    starved_seconds_counter_moves, device_iterator_values_and_lookahead,
    ingest_device_path, chaos_fetch_failures_retry_no_torn_batch],
    ids=lambda f: f.__name__)
def test_case_matches_reference(case):
    ref, port = both(case)
    assert port == ref


@pytest.mark.parametrize("case", [
    tfrecord_ranges_disjoint_and_complete, tfrecord_range_arbitrary_offsets,
    tfrecord_range_empty_cases, read_tfrecords_shards_per_file,
    parquet_row_group_ranges, parquet_zero_row_groups_not_dropped,
    sharded_file_through_ingest, expand_paths_sorted_and_deduped],
    ids=lambda f: f.__name__)
def test_files_match_reference(case, tmp_path):
    dirs = [tmp_path / "ref", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
    ref, port = both(case, ref_args=(dirs[0],), port_args=(dirs[1],))
    assert port == ref


def test_device_iterator_with_sharding():
    ref, port = both(device_iterator_with_sharding)
    assert ref == [3, True]
    assert port[0] == "NotImplementedError" and "DeviceMesh" in port[1]


# --------------------------------------------------------------------------
# elastic: the reference's shrink mid-epoch / grow at an epoch boundary
# (tests/test_data_ingest.py:742,765) on the port, with its loop in torch
# --------------------------------------------------------------------------
def _stream_loop(config):
    """Lockstep loop over the streaming shard: every step the group
    allreduces [rows, sum]; an epoch ends when the global row count is
    zero, so ranks never diverge at a shard's end."""
    import torch

    from ray_tpu_torch import collective, train

    ctx = train.get_context()
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t = ckpt.to_pytree()
        w, step = float(t["w"]), int(t["step"])
    else:
        w, step = 0.0, -1
    shard = train.get_dataset_shard("train")
    for _epoch in range(config.get("epochs", 1)):
        it = iter(shard.iter_batches(batch_size=config.get("batch", 20)))
        while True:
            batch = next(it, None)
            n = 0 if batch is None else len(batch["x"])
            contrib = 0.0 if batch is None else float(np.sum(batch["x"]))
            vec = collective.allreduce(
                torch.tensor([float(n), contrib], dtype=torch.float64),
                group_name=ctx.collective_group)
            if float(vec[0]) == 0:
                break
            w += float(vec[1])
            step += 1
            train.report(
                {"step": step, "w": w, "world": ctx.world_size},
                checkpoint={"w": torch.tensor(w, dtype=torch.float64),
                            "step": torch.tensor(step)})
            time.sleep(config.get("sleep", 0.05))


def _streaming_trainer(tmp_path, ds, *, epochs=1, num_workers=3,
                       sleep=0.25, name="stream-elastic"):
    from ray_tpu_torch.train import (CheckpointConfig, CudaTrainer,
                                     DatasetConfig, ElasticConfig,
                                     FailureConfig, RunConfig, ScalingConfig)

    return CudaTrainer(
        _stream_loop,
        train_loop_config={"epochs": epochs, "batch": 20, "sleep": sleep},
        scaling_config=ScalingConfig(
            num_workers=num_workers, use_gpu=False, worker_mode="threads",
            elastic=ElasticConfig(min_workers=1, grow_check_period_s=0.3)),
        datasets={"train": ds},
        # Shard == block == batch (20-row blocks, batch 20, window 1): a
        # claim resolves within one step, so the dataset-sum check below is
        # exact across shrink and grow.
        dataset_config=DatasetConfig(shuffle_window_blocks=1,
                                     shuffle_seed=12),
        run_config=RunConfig(
            name=name, storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(async_save=True,
                                               replica_memory_steps=2),
            failure_config=FailureConfig(max_failures=3)))


@pytest.fixture
def elastic_cluster():
    """A head with no CPU and three 1-CPU worker nodes (the elastic
    training suite's shape): killing a node drops worker capacity."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 0})
    nodes = [cluster.add_node(num_cpus=1) for _ in range(3)]
    yield cluster, nodes
    ray_tpu_torch.shutdown()
    _set_chaos(ray_tpu_torch, "")


def _fit_elastic(trainer, cluster, nodes, grow):
    """fit() on a thread; the first worker node is preempted once a step
    has committed, and (``grow``) a node is added a second later."""
    from ray_tpu_torch.autoscaler.elastic import simulate_preemption
    from ray_tpu_torch.train import run_registry

    box = {}
    t = threading.Thread(target=lambda: box.update(r=trainer.fit()),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while (run_registry.get_run(trainer.run_config.name) or {}).get(
            "last_committed_step") is None:
        assert time.monotonic() < deadline, "the run never got going"
        time.sleep(0.05)
    assert simulate_preemption(str(nodes[0])) is not None
    if grow:
        time.sleep(1.0)
        cluster.add_node(num_cpus=1)
    t.join(timeout=90)
    assert not t.is_alive(), "fit() hung after preemption"
    assert box["r"].error is None, box["r"].error
    return box["r"]


def _audit_clean(trainer, epochs):
    ing = trainer.streaming_ingests["train"]
    for epoch in range(epochs):
        audit = ing.audit(epoch)
        assert audit["double_trained"] == [], (epoch, audit)
        assert audit["untrained"] == [], (epoch, audit)


def test_streaming_shrink_mid_epoch_exactly_once(elastic_cluster, tmp_path):
    """A worker node killed mid-epoch: the survivors drain the dead rank's
    unfinished shard claims exactly once — the final sum is the dataset's
    (exact: integers in float64) and the shard ledger shows nothing double
    or dropped."""
    from ray_tpu_torch import data

    cluster, nodes = elastic_cluster
    n = 480
    ds = data.range(n, parallelism=n // 20).map_batches(
        lambda b: {"x": b["id"].astype(np.float64) + 1.0})
    trainer = _streaming_trainer(tmp_path, ds, name="stream-shrink")
    r = _fit_elastic(trainer, cluster, nodes, grow=False)
    shrinks = [e for e in r.elastic_events if e["type"] == "shrink"]
    assert shrinks and shrinks[0]["from_world"] == 3
    _audit_clean(trainer, epochs=1)
    assert r.metrics["w"] == float(sum(range(1, n + 1)))
    assert r.metrics["world"] == 2


def test_streaming_grow_epoch_boundary_resplits(elastic_cluster, tmp_path):
    """Capacity returns mid-run: the trainer grows back at a checkpoint
    boundary and later epochs re-split over the larger world — every epoch
    still sums to the dataset's exactly once."""
    from ray_tpu_torch import data

    cluster, nodes = elastic_cluster
    n, epochs = 480, 2
    ds = data.range(n, parallelism=n // 20).map_batches(
        lambda b: {"x": b["id"].astype(np.float64) + 1.0})
    trainer = _streaming_trainer(tmp_path, ds, epochs=epochs,
                                 name="stream-grow")
    r = _fit_elastic(trainer, cluster, nodes, grow=True)
    types = [e["type"] for e in r.elastic_events]
    assert "shrink" in types and "grow" in types, r.elastic_events
    _audit_clean(trainer, epochs=epochs)
    assert r.metrics["w"] == epochs * float(sum(range(1, n + 1)))
    assert r.metrics["world"] == 3
