"""Checkpoint chaos on both packages: the cases of
tests/test_checkpoint_chaos.py, each run on the reference (ray_tpu) and on
the port (ray_tpu_torch), the observations equal.

Injected failures at the subsystem's fault points (ckpt_shard_write,
ckpt_commit, ckpt_restore) and a worker failure under load. The invariant
under every fault: restore always returns the last *committed* step, and
a torn directory is never selected. The reference's Trainer loops report
JAX arrays, the port's torch tensors of the same dtypes; its ranks are
``CudaTrainer`` threads on the CPU (``use_gpu=False``).
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_train_parity import assert_same, both


def _ck(pkg):
    return importlib.import_module(pkg.__name__ + ".checkpoint")


def _layout(pkg):
    return importlib.import_module(pkg.__name__ + ".checkpoint.layout")


def _fi(pkg):
    return importlib.import_module(pkg.__name__ + "._private.fault_injection")


def _set_chaos(pkg, spec: str) -> None:
    config = importlib.import_module(pkg.__name__ + "._private.config")
    config.GLOBAL_CONFIG.testing_rpc_failure = spec
    _fi(pkg).reset_injector()


@pytest.fixture
def chaos():
    """Yields a setter for a package's fault-injection spec; always cleans
    up both."""
    yield _set_chaos
    for pkg in (ray_tpu, ray_tpu_torch):
        _set_chaos(pkg, "")


def _tree(scale: float):
    return {"w": np.full((8, 2), float(scale), np.float32),
            "step": np.int32(scale)}


def _torn_dirs(pkg, root: str):
    """Final-named dirs without the COMMIT marker (must be none)."""
    lay = _layout(pkg)
    return [n for n in os.listdir(root) if lay.parse_step(n) is not None
            and not os.path.exists(os.path.join(root, n, lay.COMMIT_MARKER))]


def _each(case, tmp_path, *args):
    out = []
    for pkg in (ray_tpu, ray_tpu_torch):
        d = tmp_path / pkg.__name__
        d.mkdir()
        out.append(case(pkg, str(d), *args))
    assert_same(out[0], out[1], atol=0)
    return out[1]


def writer_killed_mid_save(pkg, root, chaos):
    ck = _ck(pkg)
    coord = ck.CheckpointCoordinator(root, replicate_to_peer=False)
    writers = [ck.ShardWriter(coord, shard_id=i, world_size=2,
                              replicate=False) for i in range(2)]
    for h in [w.save_async(0, _tree(0)) for w in writers]:
        h.result(timeout=30)
    seen = [coord.latest_committed()]
    chaos(pkg, "ckpt_shard_write=1:1")
    handles = [w.save_async(1, _tree(1)) for w in writers]
    excs = [h.exception(timeout=30) for h in handles]
    seen += [sorted(type(e).__name__ for e in excs if e is not None),
             coord.latest_committed(), ck.latest_committed_step(root),
             _torn_dirs(pkg, root),
             np.asarray(ck.restore_latest(root)["w"]).tolist()]
    for h in [w.save_async(2, _tree(2)) for w in writers]:
        h.result(timeout=30)
    seen += [coord.latest_committed(), _torn_dirs(pkg, root),
             np.asarray(ck.restore_latest(root)["w"]).tolist()]
    for w in writers:
        w.close()
    return seen


def test_shard_writer_killed_mid_save(chaos, tmp_path):
    seen = _each(writer_killed_mid_save, tmp_path, chaos)
    assert seen[0] == 0 and "InjectedFailure" in seen[1]
    assert seen[2:5] == [0, 0, []] and seen[5] == [[0.0, 0.0]] * 8
    assert seen[6:8] == [2, []] and seen[8] == [[2.0, 2.0]] * 8


def coordinator_killed_mid_commit(pkg, root, chaos):
    ck, lay = _ck(pkg), _layout(pkg)
    coord = ck.CheckpointCoordinator(root, replicate_to_peer=False)
    w = ck.ShardWriter(coord, 0, 1, replicate=False)
    w.save_async(0, _tree(0)).result(timeout=30)
    chaos(pkg, "ckpt_commit=1:1")
    exc = w.save_async(1, _tree(1)).exception(timeout=30)
    seen = [type(exc).__name__, coord.latest_committed(),
            ck.latest_committed_step(root),
            os.path.exists(lay.final_dir(root, 1)), _torn_dirs(pkg, root),
            float(np.asarray(ck.restore_latest(root)["w"]).max())]
    w.save_async(2, _tree(2)).result(timeout=30)
    seen += [coord.latest_committed(),
             float(np.asarray(ck.restore_latest(root)["w"]).min())]
    w.close()
    return seen


def test_coordinator_killed_mid_commit(chaos, tmp_path):
    assert _each(coordinator_killed_mid_commit, tmp_path, chaos) == [
        "InjectedFailure", 0, 0, False, [], 0.0, 2, 2.0]


def restore_retryable(pkg, root, chaos):
    ck = _ck(pkg)
    coord = ck.CheckpointCoordinator(root, replicate_to_peer=False)
    w = ck.ShardWriter(coord, 0, 1, replicate=False)
    w.save_async(0, _tree(4)).result(timeout=30)
    w.close()
    chaos(pkg, "ckpt_restore=1:1")
    with pytest.raises(_fi(pkg).InjectedFailure):
        ck.restore_latest(root)
    return np.asarray(ck.restore_latest(root)["w"]).tolist()


def test_restore_failure_is_transient_and_retryable(chaos, tmp_path):
    assert _each(restore_retryable, tmp_path, chaos) == [[4.0, 4.0]] * 8


# ------------------------------------------------------- through Trainer

def _trainer(pkg, loop, storage, name, workers=2, **ckpt):
    train = importlib.import_module(pkg.__name__ + ".train")
    if pkg is ray_tpu:
        cls, scaling = train.JaxTrainer, train.ScalingConfig(
            num_workers=workers)
    else:
        cls, scaling = train.CudaTrainer, train.ScalingConfig(
            num_workers=workers, use_gpu=False)
    failures = ckpt.pop("max_failures", 0)
    return cls(loop, scaling_config=scaling, run_config=train.RunConfig(
        name=name, storage_path=storage,
        checkpoint_config=train.CheckpointConfig(async_save=True, **ckpt),
        failure_config=train.FailureConfig(max_failures=failures)))


def _state(pkg, it, shape):
    if pkg is ray_tpu:
        import jax.numpy as jnp

        return {"step": jnp.asarray(it), "w": jnp.full(shape, float(it))}
    return {"step": torch.tensor(it, dtype=torch.int32),
            "w": torch.full(shape, float(it))}


def killed_under_load(pkg, base):
    train = importlib.import_module(pkg.__name__ + ".train")
    storage = os.path.join(base, pkg.__name__)
    attempts = {"n": 0}

    def loop(config):
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            start = int(np.asarray(ckpt.to_pytree()["step"])) + 1
        for it in range(start, 5):
            train.report({"step": it}, checkpoint=_state(pkg, it, (8,)))
            if it == 2 and attempts["n"] == 0:
                attempts["n"] += 1
                time.sleep(0.5)  # let the async persist race the crash
                raise RuntimeError("simulated worker death under load")

    result = _trainer(pkg, loop, storage, "chaos_resume", num_to_keep=3,
                      max_failures=1).fit()
    root = os.path.join(storage, "chaos_resume", "checkpoints", "sharded")
    restored = result.checkpoint.to_pytree()
    steps = [m["step"] for m in result.metrics_history]
    return {"error": result.error, "last": result.metrics["step"],
            "zeros": steps.count(0), "torn": _torn_dirs(pkg, root),
            "step": int(np.asarray(restored["step"])),
            "w": np.asarray(restored["w"]).tolist()}


def test_trainer_worker_killed_under_load_auto_resumes(tmp_path):
    ref, port = both(killed_under_load, str(tmp_path),
                     init={"num_cpus": 8})
    assert ref == port
    assert port == {"error": None, "last": 4, "zeros": 1, "torn": [],
                    "step": 4, "w": [4.0] * 8}


def all_saves_failing(pkg, base):
    storage = os.path.join(base, pkg.__name__)
    train = importlib.import_module(pkg.__name__ + ".train")

    def loop(config):
        for it in range(3):
            train.report({"step": it}, checkpoint={
                "step": _state(pkg, it, (1,))["step"]})

    result = _trainer(pkg, loop, storage, "all_fail").fit()
    root = os.path.join(storage, "all_fail", "checkpoints", "sharded")
    return {"last": result.metrics["step"],
            "error": "no step ever committed" in str(result.error),
            "checkpoint": result.checkpoint,
            "committed": _layout(pkg).list_committed_steps(root)}


def test_all_async_saves_failing_surfaces_result_error(tmp_path):
    ref, port = both(all_saves_failing, str(tmp_path), init={
        "num_cpus": 8, "_system_config": {
            "testing_rpc_failure": "ckpt_shard_write=1:1000"}})
    try:
        assert ref == port == {"last": 2, "error": True, "checkpoint": None,
                               "committed": []}
    finally:
        for pkg in (ray_tpu, ray_tpu_torch):
            _set_chaos(pkg, "")


def flaky_saves(pkg, base):
    storage = os.path.join(base, pkg.__name__)
    train = importlib.import_module(pkg.__name__ + ".train")

    def loop(config):
        for it in range(6):
            train.report({"step": it}, checkpoint={
                "step": _state(pkg, it, (1,))["step"]})

    result = _trainer(pkg, loop, storage, "flaky_saves").fit()
    root = os.path.join(storage, "flaky_saves", "checkpoints", "sharded")
    committed = _layout(pkg).list_committed_steps(root)
    restored = _ck(pkg).restore_latest(root)
    return {"error": result.error, "torn": _torn_dirs(pkg, root),
            "any": bool(committed),
            "latest": int(np.asarray(restored["step"])) == committed[-1]}


def test_trainer_survives_injected_shard_write_faults(tmp_path):
    # Which saves abort depends on the two ranks' interleaving: the
    # observations are the invariants, not the committed set.
    ref, port = both(flaky_saves, str(tmp_path), init={
        "num_cpus": 8, "_system_config": {
            "testing_rpc_failure": "ckpt_shard_write=0.4:3"}})
    try:
        assert ref == port == {"error": None, "torn": [], "any": True,
                               "latest": True}
    finally:
        for pkg in (ray_tpu, ray_tpu_torch):
            _set_chaos(pkg, "")
