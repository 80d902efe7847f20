"""The port's air package and logger integrations (ray_tpu_torch.air)
against the reference's (ray_tpu.air), on the 5 cases of
tests/test_air_integrations.py, then the TensorBoard logger without
tensorboardX.

wandb and mlflow are missing on both machines, so their callbacks write
the JSONL fallback sinks; each package's half runs a ``Tuner`` in a
directory of its own and the records it wrote (record types, configs,
metrics, steps) must be equal. tensorboardX is installed here but not on
the card's machine: with it, each package writes event files; with its
import blocked, the TensorBoard callback falls back to one JSONL scalar row
per metric of each result.
"""

import glob
import importlib
import json
import os
import sys

import ray_tpu
import ray_tpu_torch
from _torch_train_parity import assert_same, both


def _tune(pkg):
    return importlib.import_module(pkg.__name__ + ".tune")


def _integrations(pkg):
    return importlib.import_module(pkg.__name__ + ".air.integrations")


def _fit_with(pkg, callbacks, root):
    tune = _tune(pkg)
    train = importlib.import_module(pkg.__name__ + ".train")

    def trainable(config):
        for i in range(3):
            train.report({"score": config["x"] * (i + 1),
                          "training_iteration": i + 1})

    return tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(
            name="air_integ", storage_path=str(root),
            stop={"training_iteration": 3}, callbacks=callbacks)).fit()


def _rows(pattern):
    """Each sink's rows, the sinks ordered by their config (trial ids are
    random)."""
    out = []
    for path in glob.glob(pattern, recursive=True):
        with open(path) as f:
            out.append([json.loads(line) for line in f])
    return sorted(out, key=lambda rows: json.dumps(rows[0], sort_keys=True)
                  + json.dumps(rows[1:], sort_keys=True))


def _parity(case, *args):
    ref, port = both(case, *args)
    assert_same(ref, port, atol=0)
    return port


def air_surface(pkg):
    air = importlib.import_module(pkg.__name__ + ".air")
    train = importlib.import_module(pkg.__name__ + ".train")
    return {"all": sorted(air.__all__),
            "same": [air.RunConfig is train.RunConfig,
                     air.ScalingConfig is train.ScalingConfig,
                     air.FailureConfig is train.FailureConfig,
                     air.CheckpointConfig is train.CheckpointConfig,
                     air.Checkpoint is train.Checkpoint],
            "session": callable(air.session.report)
            and callable(air.session.get_checkpoint)
            and callable(air.session.get_context)}


def test_air_surface_reexports():
    port = [air_surface(pkg) for pkg in (ray_tpu, ray_tpu_torch)]
    assert_same(*port)
    assert all(port[1]["same"]) and port[1]["session"]


def wandb_offline(pkg, tmp_path):
    root = tmp_path / pkg.__name__
    results = _fit_with(pkg, [_integrations(pkg).WandbLoggerCallback(
        project="t")], root)
    files = [_deterministic(rows) for rows in
             _rows(str(root / "**" / "wandb_offline" / "*.jsonl"))]
    for rows in files:
        rows[0]["config"] = sorted(rows[0]["config"].items())
    return {"trials": len(results), "files": files}


def test_wandb_callback_offline_sink(tmp_path):
    port = _parity(wandb_offline, tmp_path)
    assert port["trials"] == 2 and len(port["files"]) == 2
    rows = port["files"][0]
    assert rows[0]["type"] == "config" and ["x", 1.0] in rows[0]["config"]
    logs = [r for r in rows if r["type"] == "log"]
    assert len(logs) == 3 and logs[-1]["metrics"]["score"] == 3.0
    assert rows[-1]["type"] == "finish"


def _deterministic(rows):
    """Rows without each result's wall-clock metrics."""
    drop = ("time_total_s", "timestamp")
    out = []
    for r in rows:
        r = dict(r)
        if "metrics" in r:
            r["metrics"] = {k: v for k, v in r["metrics"].items()
                            if k not in drop}
        out.append(r)
    return out


def mlflow_offline(pkg, tmp_path):
    root = tmp_path / pkg.__name__
    _fit_with(pkg, [_integrations(pkg).MLflowLoggerCallback(
        experiment_name="t")], root)
    return [_deterministic(rows) for rows in
            _rows(str(root / "**" / "mlruns_offline" / "*.jsonl"))]


def test_mlflow_callback_offline_sink(tmp_path):
    port = _parity(mlflow_offline, tmp_path)
    assert len(port) == 2
    rows = port[0]
    assert rows[0]["type"] == "params"
    assert sum(r["type"] == "metrics" for r in rows) == 3
    assert rows[-1]["type"] == "end"


def tbx_event_files(pkg, tmp_path):
    root = tmp_path / pkg.__name__
    _fit_with(pkg, [_integrations(pkg).TBXLoggerCallback()], root)
    events = glob.glob(str(root / "**" / "events.out.tfevents.*"),
                       recursive=True)
    return {"files": len(events),
            "written": sum(os.path.getsize(e) > 0 for e in events)}


def test_tbx_callback_writes_event_files(tmp_path):
    port = _parity(tbx_event_files, tmp_path)
    assert port["files"] >= 2 and port["written"] >= 1


def setup_helpers(pkg, tmp_path):
    cwd = os.getcwd()
    d = tmp_path / pkg.__name__
    d.mkdir()
    os.chdir(d)
    try:
        integ = _integrations(pkg)
        run = integ.setup_wandb({"lr": 0.1}, project="p", trial_id="t1")
        run.log({"loss": 1.0, "step": 999}, step=0)
        run.finish()
        ml = integ.setup_mlflow({"lr": 0.2}, experiment_name="e1")
        ml.log_metrics({"acc": 0.5}, step=1)
        ml.end_run()
    finally:
        os.chdir(cwd)
    out = {}
    for name, path in (("wandb", run.path), ("mlflow", ml.path)):
        assert os.path.relpath(path, d) == \
            {"wandb": "wandb_offline/t1.jsonl",
             "mlflow": "mlruns_offline/e1.jsonl"}[name]
        with open(path) as f:
            out[name] = [json.loads(line) for line in f]
    return out


def test_setup_helpers_shim(tmp_path):
    port = [setup_helpers(pkg, tmp_path) for pkg in (ray_tpu, ray_tpu_torch)]
    assert_same(*port, atol=0)
    rows = port[1]["wandb"]
    assert rows[0]["config"] == {"lr": 0.1}
    assert rows[1]["metrics"]["loss"] == 1.0
    assert rows[1]["step"] == 0  # a metric named "step" cannot clobber it
    assert port[1]["mlflow"][0]["params"] == {"lr": 0.2}
    assert port[1]["mlflow"][1]["metrics"]["acc"] == 0.5


def tbx_jsonl_fallback(pkg, tmp_path):
    """tensorboardX blocked (as on the card's machine): one JSONL file per
    trial, one scalar row per numeric metric of each result."""
    root = tmp_path / pkg.__name__
    saved = sys.modules.get("tensorboardX")
    sys.modules["tensorboardX"] = None  # the import now raises
    try:
        grid = _fit_with(pkg, [_integrations(pkg).TBXLoggerCallback()], root)
    finally:
        if saved is None:
            del sys.modules["tensorboardX"]
        else:
            sys.modules["tensorboardX"] = saved
    files = _rows(str(root / "**" / "*.jsonl"))
    per_result = [len([k for k, v in m.items() if isinstance(v, (int, float))
                       and not isinstance(v, bool)])
                  for r in grid for m in r.metrics_history]
    return {"files": [[r["type"] for r in rows] for rows in files],
            "scores": sorted([r["value"] for r in rows
                              if r.get("tag") == "score"] for rows in files),
            "steps": sorted([r["step"] for r in rows
                             if r.get("tag") == "score"] for rows in files),
            "scalar_rows": sum(len(rows) - 1 for rows in files),
            "numeric_metrics": sum(per_result),
            "events": len(glob.glob(str(root / "**" / "events.out.*"),
                                    recursive=True))}


def test_tbx_falls_back_to_jsonl_without_tensorboardx(tmp_path):
    port = _parity(tbx_jsonl_fallback, tmp_path)
    assert port["events"] == 0 and len(port["files"]) == 2
    assert all(types[0] == "tbx_fallback" for types in port["files"])
    assert port["scores"] == [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0]]
    assert port["steps"] == [[1, 2, 3], [1, 2, 3]]
    assert port["scalar_rows"] == port["numeric_metrics"]
