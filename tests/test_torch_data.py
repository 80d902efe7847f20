"""The port's Ray Data (ray_tpu_torch.data) against the reference
(ray_tpu.data) on the cases of tests/test_data.py.

Each case runs on both packages, one after the other, on the same numpy
inputs, and what the port observed must equal what the reference observed:
rows and their order, seeded shuffles, aggregates, batch shapes and dtypes,
and the bytes of the files each writes. The reference's Trainer case
(``test_dataset_with_train_ingest``) waits for the port's Trainer; its
mirror here feeds the same dataset to two consumers of one streaming ingest,
the path ``get_dataset_shard`` hands a Trainer's workers.
"""

import glob
import os

import numpy as np
import pytest

from _torch_data import both, raises


def _ids(rows, key="id"):
    return [r[key] for r in rows]


def range_count_take(pkg, data):
    ds = data.range(1000)
    return [ds.count(), ds.take(5)]


def map_batches(pkg, data):
    ds = data.range(100).map_batches(lambda b: {"sq": b["id"] ** 2})
    return [ds.sum("sq"), ds.take_all()]


def map_filter_flat_map(pkg, data):
    ds = data.range(20).map(lambda r: {"x": int(r["id"]) * 2})
    ds = ds.filter(lambda r: r["x"] % 4 == 0)
    ds = ds.flat_map(lambda r: [{"y": r["x"]}, {"y": r["x"] + 1}])
    return ds.take_all()


def operator_fusion(pkg, data):
    plan = pkg.data.plan
    ds = data.range(10).map(lambda r: {"x": int(r["id"])}).map(
        lambda r: {"x": r["x"] + 1}).map(lambda r: {"x": r["x"] * 2})
    fused = plan.fuse_maps(ds._op.chain())
    return [[op.name for op in fused], ds.take(3)]


def limit_streaming(pkg, data):
    # range(10_000) reads 8 blocks, streamed as their tasks finish: which
    # 25 rows come first is not defined.
    ds = data.range(10_000).limit(25)
    return [ds.count(), len(ds.take_all())]


def batch_formats(pkg, data):
    ds = data.range(10)
    pandas = [{"columns": list(b.columns), "id": b["id"].tolist()}
              for b in ds.iter_batches(batch_size=4, batch_format="pandas")]
    arrays = list(ds.iter_batches(batch_size=4, batch_format="numpy"))
    return [pandas, arrays]


def iter_batches_exact_sizes(pkg, data):
    return [len(b["id"]) for b in data.range(103).iter_batches(batch_size=25)]


def tensor_columns_roundtrip(pkg, data):
    arr = np.random.default_rng(0).random((32, 8, 4)).astype(np.float32)
    out = next(iter(data.from_numpy(arr, column="img").iter_batches(
        batch_size=32)))
    return [out["img"], out["img"].tobytes() == arr.tobytes()]


def sort_shuffle_repartition(pkg, data):
    ds = data.from_items([{"v": i} for i in [3, 1, 2]])
    return [_ids(ds.sort("v").take_all(), "v"),
            _ids(ds.sort("v", descending=True).take_all(), "v"),
            _ids(data.range(100).random_shuffle(seed=0).take_all()),
            len(list(data.range(100).repartition(7).iter_block_refs()))]


def union_groupby(pkg, data):
    a = data.from_items([{"k": "x", "v": 1}, {"k": "y", "v": 2}])
    b = data.from_items([{"k": "x", "v": 10}])
    u = a.union(b)
    return [u.count(), u.take_all(), u.groupby("k").sum("v").take_all()]


def aggregations(pkg, data):
    ds = data.range(10)
    return [ds.min("id"), ds.max("id"), ds.mean("id"), ds.sum("id")]


def _file_bytes(path, ext):
    return [open(f, "rb").read()
            for f in sorted(glob.glob(os.path.join(path, f"*.{ext}")))]


def parquet_roundtrip(pkg, data, path):
    data.range(50).map(lambda r: {"id": int(r["id"]),
                                  "sq": int(r["id"]) ** 2}).write_parquet(path)
    back = data.read_parquet(path)
    return [back.count(), back.sum("sq"), back.take_all(),
            _file_bytes(path, "parquet")]


def csv_roundtrip(pkg, data, path):
    data.from_items([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]).write_csv(path)
    back = data.read_csv(path)
    return [back.sort("a").take_all(), _file_bytes(path, "csv")]


def actor_pool_map_batches(pkg, data):
    class Doubler:
        def __init__(self):
            self.calls = 0

        def __call__(self, batch):
            self.calls += 1
            return {"out": batch["id"] * 2}

    ds = data.range(100).map_batches(Doubler, batch_size=10, concurrency=2)
    return [ds.sum("out"), sorted(_ids(ds.take_all(), "out"))]


def streaming_split_coordinated(pkg, data):
    its = data.range(100).streaming_split(2)
    return [_ids(its[0].iter_rows()), _ids(its[1].iter_rows())]


def split(pkg, data):
    return [p.take_all() for p in data.range(10).split(3)]


def to_pandas_schema(pkg, data):
    ds = data.from_items([{"a": 1, "b": "x"}])
    df = ds.to_pandas()
    return [list(df.columns), df.to_dict("list"), ds.schema().names,
            ds.columns()]


def streaming_ingest_two_consumers(pkg, data):
    """The reference's test_dataset_with_train_ingest without its Trainer:
    two consumers of one streaming ingest, each claiming source shards of
    the same epoch; every row reaches exactly one of them."""
    from importlib import import_module

    ingest = import_module(pkg.__name__ + ".data.ingest")
    ds = data.range(64).map_batches(
        lambda b: {"x": b["id"].astype(np.float32)})
    ing = ingest.StreamingIngest(ds, seed=0)
    a, b = ing.make_shard(), ing.make_shard()
    got = [[float(v) for batch in s.iter_batches(batch_size=8)
            for v in batch["x"]] for s in (a, b)]
    return [got, sorted(got[0] + got[1]) == [float(i) for i in range(64)],
            sum(got[0]) + sum(got[1]), ing.audit(0)]


def streaming_split_multi_epoch(pkg, data):
    its = data.range(32).streaming_split(2)
    return [[sum(len(b["id"]) for b in it.iter_batches(batch_size=4))
             for it in its] for _ in range(3)]


def streaming_split_sequential_consumption(pkg, data):
    its = data.range(2000).repartition(200).streaming_split(2)
    return [sum(len(b["id"]) for b in it.iter_batches(batch_size=100))
            for it in its]


def from_items_heterogeneous_keys(pkg, data):
    return data.from_items([{"a": 1}, {"a": 2, "b": 3}]).take_all()


def map_batches_class_requires_actor_pool(pkg, data):
    class Doubler:
        def __call__(self, batch):
            return {"id": batch["id"] * 2}

    return raises(lambda: data.range(8).map_batches(
        Doubler, compute=pkg.data.plan.ComputeStrategy()))


@pytest.mark.parametrize("case", [
    range_count_take, map_batches, map_filter_flat_map, operator_fusion,
    limit_streaming, batch_formats, iter_batches_exact_sizes,
    tensor_columns_roundtrip, sort_shuffle_repartition, union_groupby,
    aggregations, actor_pool_map_batches, streaming_split_coordinated, split,
    to_pandas_schema, streaming_ingest_two_consumers,
    streaming_split_multi_epoch, streaming_split_sequential_consumption,
    from_items_heterogeneous_keys, map_batches_class_requires_actor_pool],
    ids=lambda f: f.__name__)
def test_case_matches_reference(case):
    ref, port = both(case)
    assert port == ref


@pytest.mark.parametrize("case", [parquet_roundtrip, csv_roundtrip],
                         ids=lambda f: f.__name__)
def test_written_files_match_reference(case, tmp_path):
    ref, port = both(case, ref_args=(str(tmp_path / "ref"),),
                     port_args=(str(tmp_path / "port"),))
    assert port == ref
