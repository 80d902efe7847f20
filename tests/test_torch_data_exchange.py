"""The port's distributed exchange (ray_tpu_torch.data.exchange: shuffle,
sort, repartition and grouped work as task stages) against the reference
on the cases of tests/test_data_exchange.py.

Each case runs on both packages on the same numpy inputs; rows, their
order, seeded shuffles and aggregates must be equal. The reference's
two-node case waits for the port's multi-node runtime (ROADMAP.md, Queue 1
item 13.8).
"""

import glob
import threading
from importlib import import_module

import numpy as np
import pytest

from _torch_data import both


def sort_100_blocks_globally_ordered(pkg, data):
    rng = np.random.default_rng(0)
    items = [{"k": int(v), "p": i} for i, v in
             enumerate(rng.integers(0, 10_000, 2000))]
    out = data.from_items(items).repartition(100).sort("k").take_all()
    keys = [r["k"] for r in out]
    return [out, keys == sorted(keys),
            sorted(r["p"] for r in out) == list(range(2000))]


def sort_descending(pkg, data):
    ds = data.range(500).repartition(20).sort("id", descending=True)
    return [r["id"] for r in ds.take_all()]


def random_shuffle_preserves_multiset_and_seeds(pkg, data):
    ds = data.range(1000).repartition(50)
    a = [r["id"] for r in ds.random_shuffle(seed=7).take_all()]
    b = [r["id"] for r in ds.random_shuffle(seed=7).take_all()]
    c = [r["id"] for r in ds.random_shuffle(seed=8).take_all()]
    return [a, c, a == b, sorted(a) == list(range(1000))]


def repartition_preserves_order(pkg, data):
    ds = data.range(101).repartition(7)
    return [[b.count() for b in _blocks(pkg, ds)], ds.take_all()]


def _blocks(pkg, ds):
    return [type(ds)(pkg.data.plan.InputData([ref]))
            for ref in ds.iter_block_refs()]


def _by_key(rows, key):
    # Grouped partitions come back as their reduce tasks finish: the
    # reference defines no order between groups.
    return sorted(rows, key=lambda r: r[key])


def groupby_across_many_blocks(pkg, data):
    items = [{"k": f"key{i % 13}", "v": i} for i in range(1300)]
    return _by_key(data.from_items(items).repartition(40).groupby("k").sum(
        "v").take_all(), "k")


def global_aggregates_partial_states(pkg, data):
    ds = data.range(1000).repartition(30)
    return [ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id"),
            ds.std("id")]


def global_quantile_and_unique(pkg, data):
    agg = import_module(pkg.__name__ + ".data.aggregate")
    ds = data.from_items([{"v": i % 10} for i in range(400)]).repartition(16)
    return ds.aggregate(agg.Quantile("v", q=0.5), agg.Unique("v"))


def grouped_quantile_and_unique(pkg, data):
    agg = import_module(pkg.__name__ + ".data.aggregate")
    rng = np.random.default_rng(0)
    rows = [{"g": int(i % 5), "v": float(rng.normal(i % 5, 1.0))}
            for i in range(500)]
    out = data.from_items(rows).repartition(12).groupby("g").aggregate(
        agg.Quantile("v", q=0.25), agg.Mean("v")).take_all()
    rows2 = [{"g": i % 3, "k": (i * 7) % 4} for i in range(120)]
    uniq = data.from_items(rows2).repartition(8).groupby("g").aggregate(
        agg.Unique("k")).take_all()
    return [_by_key(out, "g"), _by_key(uniq, "g")]


def tensor_columns_roundtrip_exchange_and_parquet(pkg, data, path):
    import pyarrow.parquet as pq

    imgs = np.arange(20 * 4 * 4 * 3, dtype=np.float32).reshape(20, 4, 4, 3)
    ds = data.from_items([{"id": i, "img": imgs[i]} for i in range(20)]) \
        .repartition(5)
    shuffled = ds.random_shuffle(seed=0).take_all()
    ds.write_parquet(path)
    # Read tasks finish in any order: the reference defines none here.
    back = sorted(data.read_parquet(path).take_all(), key=lambda r: r["id"])
    field = pq.read_table(sorted(glob.glob(
        path + "/*.parquet"))[0]).schema.field("img")
    tensor_type = pkg.data.block.ArrowTensorType
    return [shuffled, back, isinstance(field.type, tensor_type),
            field.type.shape]


def shuffle_driver_never_concats_dataset(pkg, data):
    exchange = import_module(pkg.__name__ + ".data.exchange")
    driver_thread = threading.get_ident()
    orig = exchange._merge
    violations = []

    def spy(parts):
        if threading.get_ident() == driver_thread:
            violations.append(threading.current_thread().name)
        return orig(parts)

    exchange._merge = spy
    try:
        ids = [r["id"] for r in data.range(2000).repartition(64)
               .random_shuffle(seed=1).take_all()]
    finally:
        exchange._merge = orig
    return [ids, violations]


@pytest.mark.parametrize("case", [
    sort_100_blocks_globally_ordered, sort_descending,
    random_shuffle_preserves_multiset_and_seeds, repartition_preserves_order,
    groupby_across_many_blocks, global_aggregates_partial_states,
    global_quantile_and_unique, grouped_quantile_and_unique,
    shuffle_driver_never_concats_dataset], ids=lambda f: f.__name__)
def test_case_matches_reference(case):
    ref, port = both(case)
    assert port == ref


def test_tensor_columns_roundtrip_exchange_and_parquet(tmp_path):
    ref, port = both(tensor_columns_roundtrip_exchange_and_parquet,
                     ref_args=(str(tmp_path / "ref"),),
                     port_args=(str(tmp_path / "port"),))
    assert port == ref
    assert port[2] is True and port[3] == [4, 4, 3]
