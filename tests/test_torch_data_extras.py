"""The port's Data extras (zip, file datasources, torch iteration,
preprocessors, backpressure, actor-pool autoscaling, aggregates) against
the reference on the cases of tests/test_data_extras.py.

Each case runs on both packages on the same inputs; what each observed must
be equal. The port's ``iter_torch_batches`` puts batches on the GPU unless
asked for the host, so its half passes ``device="cpu"`` (the reference's
default).
"""

import threading
import time
from importlib import import_module

import numpy as np
import pytest

from _torch_data import both, raises


def _pre(pkg):
    return import_module(pkg.__name__ + ".data.preprocessors")


def _torch_kw(pkg):
    return {"device": "cpu"} if pkg.__name__ == "ray_tpu_torch" else {}


def zip_aligns_rows_and_renames_dupes(pkg, data):
    a = data.range(6)
    b = data.range(6).map_batches(lambda x: {"id": x["id"] * 10,
                                             "y": x["id"]})
    return [a.zip(b).take_all(),
            raises(lambda: data.range(3).zip(data.range(4)).take_all())]


def zip_is_lazy_and_rename_avoids_collisions(pkg, data):
    calls = {"n": 0}

    def tracked(batch):
        calls["n"] += 1
        return batch

    z = data.range(4).map_batches(tracked).zip(data.range(4))
    before = calls["n"]
    z.take_all()
    left = data.range(4).map_batches(lambda b: {"id": b["id"],
                                                "id_1": b["id"] + 100})
    return [before, calls["n"] > 0, left.zip(data.range(4)).take_all()]


def read_text_and_binary(pkg, data, tmp):
    (tmp / "a.txt").write_text("one\ntwo\n")
    (tmp / "b.txt").write_text("three\n")
    text = sorted(r["text"] for r in data.read_text(str(tmp)).take_all())
    raw = tmp / "blob.bin"
    raw.write_bytes(b"\x00\x01payload")
    row = data.read_binary_files(str(raw), include_paths=True).take_all()[0]
    return [text, row["bytes"], row["path"].endswith("blob.bin")]


def read_images(pkg, data, tmp):
    from PIL import Image

    for i, color in enumerate([(255, 0, 0), (0, 255, 0)]):
        Image.new("RGB", (8, 6), color).save(tmp / f"img{i}.png")
    rows = data.read_images(str(tmp), size=(3, 4), mode="RGB",
                            include_paths=True).take_all()
    return sorted([[r["image"], r["path"].rsplit("/", 1)[1]] for r in rows],
                  key=lambda x: x[1])


def read_images_mixed_sizes_and_modes_are_uniformed(pkg, data, tmp):
    from PIL import Image

    Image.new("RGB", (8, 6), (1, 2, 3)).save(tmp / "a.png")
    Image.new("L", (4, 4), 7).save(tmp / "b.png")
    (tmp / "sub").mkdir()
    batches = list(data.read_images(str(tmp)).iter_batches(batch_size=2))
    imgs = batches[0]["image"]
    return [imgs.shape, sorted(imgs.reshape(2, -1).tolist())]


def read_text_empty_file_schema(pkg, data, tmp):
    (tmp / "full.txt").write_text("x\n")
    (tmp / "empty.txt").write_text("")
    return data.read_text(str(tmp)).zip(data.from_items([{"n": 1}])).take_all()


def iter_torch_batches_uint16(pkg, data):
    ds = data.from_numpy(np.arange(6, dtype=np.uint16), column="u")
    out = list(ds.iter_torch_batches(batch_size=6, **_torch_kw(pkg)))[0]["u"]
    return [str(out.dtype), out.tolist(), out.device.type]


def iter_torch_batches(pkg, data):
    import torch

    ds = data.range(10).map_batches(lambda b: {"id": b["id"],
                                               "x": b["id"] * 0.5})
    batches = list(ds.iter_torch_batches(batch_size=4, **_torch_kw(pkg)))
    return [[{k: [str(v.dtype), v.tolist(), isinstance(v, torch.Tensor)]
              for k, v in b.items()} for b in batches],
            list(torch.cat([b["id"] for b in batches]).shape)]


def standard_and_minmax_scalers(pkg, data):
    pre = _pre(pkg)
    ds = data.from_items([{"a": float(i), "b": float(i * 2)}
                          for i in range(8)])
    sc = pre.StandardScaler(["a"]).fit(ds)
    a = np.concatenate([b["a"] for b in sc.transform(ds).iter_batches()])
    mm = pre.MinMaxScaler(["b"]).fit(ds)
    b = np.concatenate([b["b"] for b in mm.transform(ds).iter_batches()])
    return [sc.stats_, a, mm.stats_, b]


def label_and_onehot_encoders(pkg, data):
    pre = _pre(pkg)
    ds = data.from_items([{"cls": c, "v": 1.0} for c in
                          ["cat", "dog", "cat", "bird"]])
    le = pre.LabelEncoder("cls").fit(ds)
    oh = pre.OneHotEncoder(["cls"]).fit(ds)
    return [le.classes_, le.transform(ds).take_all(),
            oh.transform(ds).take_all()]


def imputer_concatenator_chain(pkg, data):
    pre = _pre(pkg)
    ds = data.from_items([
        {"a": 1.0, "b": 2.0}, {"a": float("nan"), "b": 4.0},
        {"a": 3.0, "b": float("nan")}])
    chain = pre.Chain(pre.SimpleImputer(["a", "b"]),
                      pre.Concatenator(["a", "b"],
                                       output_column_name="features"))
    chain.fit(ds)
    direct = chain.transform_batch({"a": np.asarray([float("nan")]),
                                    "b": np.asarray([4.0])})
    return [chain.transform(ds).take_all(), direct]


def unfit_preprocessor_raises(pkg, data):
    return raises(lambda: _pre(pkg).StandardScaler(["a"]).transform(
        data.range(3)))


def backpressure_slow_consumer_bounds_in_flight(pkg, data):
    live = []
    peak = [0]
    lock = threading.Lock()

    def tracked(batch):
        with lock:
            live.append(1)
            peak[0] = max(peak[0], len(live))
        time.sleep(0.01)
        with lock:
            live.pop()
        return batch

    ds = data.range(200, parallelism=40).map_batches(tracked)
    it = iter(ds.iter_batches(batch_size=5))
    first = next(it)
    time.sleep(0.5)
    n = len(first["id"]) + sum(len(b["id"]) for b in it)
    cap = import_module(pkg.__name__ + ".data.executor").MAX_IN_FLIGHT
    return [n, cap, peak[0] <= cap + 1]


def resource_budget_tightens_with_block_size(pkg, data):
    ex = import_module(pkg.__name__ + ".data.executor")
    big = import_module(pkg.__name__ + ".data.block").block_from_batch(
        {"x": np.arange(200_000, dtype=np.int64)})  # 1.6 MB
    b = ex.ResourceBudget(task_cap=8)
    caps = [b.cap()]
    for _ in range(5):
        b.observe_block(big)
    caps.append(b.cap())
    b2 = ex.ResourceBudget(task_cap=1000, mem_fraction=1e-6)
    b2.observe_block(big)
    return [caps, b2.cap(), max(1, int((64 << 20) // big.nbytes))]


def actor_pool_autoscales_under_backlog(pkg, data):
    class SlowModel:
        def __init__(self):
            import uuid

            self.ident = uuid.uuid4().hex

        def __call__(self, batch):
            time.sleep(0.05)
            batch["y"] = batch["id"] * 2
            batch["actor"] = [self.ident] * len(batch["id"])
            return batch

    out = data.range(64, parallelism=16).map_batches(
        SlowModel, concurrency=(1, 4), batch_size=4).take_all()
    return [sorted((r["id"], r["y"]) for r in out),
            len({r["actor"] for r in out}) >= 2]


def map_batches_tuple_concurrency_builds_autoscaling_pool(pkg, data):
    op = data.range(10).map_batches(lambda b: b, concurrency=(2, 5))._op
    return [type(op.compute).__name__, op.compute.pool_size,
            op.compute.max_size, op.compute.resources]


def std_unique_quantile(pkg, data):
    agg = import_module(pkg.__name__ + ".data.aggregate")
    ds = data.from_items([{"k": i % 3, "v": float(i)} for i in range(30)])
    return [ds.std("v"), ds.unique("k"), ds.aggregate(agg.Quantile("v",
                                                                   q=0.5)),
            list(ds.aggregate(agg.Unique("k"))),
            ds.aggregate(agg.Sum("v"), agg.Min("v"), agg.Max("v"),
                         agg.Mean("v"), agg.Count())]


def grouped_aggregate_multi(pkg, data):
    agg = import_module(pkg.__name__ + ".data.aggregate")
    ds = data.from_items([{"k": i % 2, "v": float(i)} for i in range(10)])
    return [ds.groupby("k").aggregate(agg.Sum("v"), agg.Mean("v"),
                                      agg.Std("v")).take_all(),
            ds.groupby("k").std("v").take_all()]


def map_groups(pkg, data):
    ds = data.from_items([{"k": i % 3, "v": float(i)} for i in range(12)])

    def summarize(batch):
        return {"k": batch["k"][:1], "total": [float(batch["v"].sum())],
                "n": [len(batch["v"])]}

    return [ds.groupby("k").map_groups(summarize).take_all(),
            ds.groupby(None).map_groups(
                lambda b: {"n": [len(b["v"])]}).take_all()]


@pytest.mark.parametrize("case", [
    zip_aligns_rows_and_renames_dupes,
    zip_is_lazy_and_rename_avoids_collisions, iter_torch_batches_uint16,
    iter_torch_batches, standard_and_minmax_scalers,
    label_and_onehot_encoders, imputer_concatenator_chain,
    unfit_preprocessor_raises, backpressure_slow_consumer_bounds_in_flight,
    resource_budget_tightens_with_block_size,
    actor_pool_autoscales_under_backlog,
    map_batches_tuple_concurrency_builds_autoscaling_pool,
    std_unique_quantile, grouped_aggregate_multi, map_groups],
    ids=lambda f: f.__name__)
def test_case_matches_reference(case):
    ref, port = both(case)
    assert port == ref


@pytest.mark.parametrize("case", [
    read_text_and_binary, read_images,
    read_images_mixed_sizes_and_modes_are_uniformed,
    read_text_empty_file_schema], ids=lambda f: f.__name__)
def test_reader_matches_reference(case, tmp_path):
    dirs = [tmp_path / "ref", tmp_path / "port"]
    for d in dirs:
        d.mkdir()
    ref, port = both(case, ref_args=(dirs[0],), port_args=(dirs[1],))
    assert port == ref
