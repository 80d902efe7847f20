"""The port's checkpoint package (ray_tpu_torch.checkpoint) against the
reference's (ray_tpu.checkpoint) on the cases of
tests/test_checkpoint_subsystem.py, then the cases across the two
packages.

Each case runs on both packages, the reference's first, each in its own
directory, and returns what it observed; the observations must be equal
(integers, strings and float values exactly). The trees come from a numpy
seed and hold fp32 leaves and one bfloat16 leaf (``mu``, as the port's
AdamW keeps its first moment): the reference's as JAX arrays, the port's
as torch tensors. A bfloat16 leaf is observed as its 16-bit patterns: the
reference restores it as ``|V2`` bytes (its ``layout.assemble_tree``
never casts them back), the port as ``torch.bfloat16``, and the bits must
agree. Cases that need a runtime start each package's in turn
(tests/_torch_train_parity.py). ``test_peer_holder_placement_and_fetch``
needs a second node, which the port's runtime does not have yet
(ROADMAP.md, Queue 1 item 13.8a): here both packages start no holder on
one node. The reference's mesh restore becomes a restore of two shards at
world sizes 1 and 4; the port's ``mesh=`` raises.
"""

import collections
import importlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both


def _ck(pkg):
    return importlib.import_module(pkg.__name__ + ".checkpoint")


def _layout(pkg):
    return importlib.import_module(pkg.__name__ + ".checkpoint.layout")


def _bf16(pkg, a):
    if pkg is ray_tpu:
        import jax.numpy as jnp

        return jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(a).to(torch.bfloat16)


def _tree(pkg, scale: float):
    """A tree with a shardable matrix, a scalar, nested containers and a
    bfloat16 leaf."""
    rng = np.random.default_rng(int(scale * 100))
    return {
        "w": (np.arange(32, dtype=np.float32).reshape(8, 4) + 1) * scale,
        "b": np.float32(scale),
        "opt": [np.ones((3,), np.float32) * scale,
                {"m": np.full((2, 2), scale, np.float32)}],
        "mu": _bf16(pkg, rng.normal(size=(8, 2)).astype(np.float32)),
    }


def bits(x):
    """An observation of a tree: arrays as numpy, bfloat16 as its bits,
    dicts in key order (as JAX orders them; the skeleton test below holds
    the stored order itself)."""
    if isinstance(x, dict):
        return {k: bits(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return [bits(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if hasattr(x, "dtype") and (str(x.dtype) == "bfloat16"
                                or np.dtype(x.dtype).kind == "V"):
        return np.asarray(x).view(np.uint16)
    if hasattr(x, "__array__") and not isinstance(x, (str, bytes)):
        return np.asarray(x)
    return x


def _equal(got, want):
    assert_same(bits(want), bits(got), atol=0)


def _each(case, tmp_path, *args):
    """(reference's observation, port's), each in a directory of its own."""
    out = []
    for pkg in (ray_tpu, ray_tpu_torch):
        d = tmp_path / pkg.__name__
        d.mkdir()
        out.append(case(pkg, d, *args))
    return out


def _parity(case, tmp_path, *args):
    ref, port = _each(case, tmp_path, *args)
    assert_same(ref, port, atol=0)
    return port


def _writer(pkg, coord, shard_id=0, world_size=1, **kw):
    kw.setdefault("replicate", False)
    return _ck(pkg).ShardWriter(coord, shard_id=shard_id,
                                world_size=world_size, **kw)


def _coord(pkg, root, **kw):
    kw.setdefault("replicate_to_peer", False)
    return _ck(pkg).CheckpointCoordinator(str(root), **kw)


# ------------------------------------------------------------------ layout

def single_shard_save_commit_restore(pkg, d):
    root = str(d)
    coord = _coord(pkg, root)
    w = _writer(pkg, coord)
    manifest = w.save_async(0, _tree(pkg, 1.0)).result(timeout=30)
    w.drain(timeout=30)
    w.close()
    restored = _ck(pkg).restore_latest(root)
    _equal(restored, _tree(pkg, 1.0))
    return {"shard": manifest["shard_id"], "bytes": manifest["bytes"] > 0,
            "latest": coord.latest_committed(),
            "committed": _ck(pkg).is_committed_dir(
                _layout(pkg).final_dir(root, 0)),
            "tree": bits(restored)}


def test_single_shard_save_commit_restore(tmp_path):
    _parity(single_shard_save_commit_restore, tmp_path)


def two_phase_partial_shard_set(pkg, d):
    root, lay, ck = str(d), _layout(pkg), _ck(pkg)
    coord = _coord(pkg, root)
    writers = [_writer(pkg, coord, i, 2) for i in range(2)]
    tree = _tree(pkg, 2.0)
    writers[0].save_async(0, tree).result(timeout=30)
    seen = {"pending": [coord.latest_committed(),
                        ck.latest_committed_step(root),
                        os.path.isdir(lay.tmp_dir(root, 0)),
                        os.path.exists(lay.final_dir(root, 0))]}
    writers[1].save_async(0, tree).result(timeout=30)
    seen["committed"] = [coord.latest_committed(),
                         os.path.exists(lay.tmp_dir(root, 0))]
    restored = ck.restore_pytree(lay.final_dir(root, 0))
    _equal(restored, tree)
    seen["tree"] = bits(restored)
    for w in writers:
        w.close()
    return seen


def test_two_phase_commit_partial_shard_set_never_visible(tmp_path):
    seen = _parity(two_phase_partial_shard_set, tmp_path)
    assert seen["pending"] == [None, None, True, False]
    assert seen["committed"] == [0, False]


def torn_directory(pkg, d):
    root, lay, ck = str(d), _layout(pkg), _ck(pkg)
    coord = _coord(pkg, root)
    w = _writer(pkg, coord)
    w.save_async(0, _tree(pkg, 1.0)).result(timeout=30)
    w.close()
    torn = lay.final_dir(root, 7)
    shutil.copytree(lay.final_dir(root, 0), torn)
    os.remove(os.path.join(torn, lay.COMMIT_MARKER))
    with pytest.raises(ValueError, match="torn"):
        ck.restore_pytree(torn)
    return [ck.is_committed_dir(torn), ck.latest_committed_step(root),
            _coord(pkg, root).latest_committed()]


def test_torn_directory_is_never_selected(tmp_path):
    assert _parity(torn_directory, tmp_path) == [False, 0, 0]


def restart_rescan_and_sweep(pkg, d):
    root, lay = str(d), _layout(pkg)
    c1 = _coord(pkg, root)
    w = _writer(pkg, c1)
    for step in range(3):
        w.save_async(step, _tree(pkg, step + 1.0)).result(timeout=30)
    w.close()
    os.makedirs(lay.tmp_dir(root, 9))
    c2 = _coord(pkg, root)
    restored = _ck(pkg).restore_latest(root)
    _equal(restored, _tree(pkg, 3.0))
    return [c2.committed_steps(), os.path.exists(lay.tmp_dir(root, 9)),
            bits(restored)]


def test_coordinator_restart_rescan_and_stale_tmp_sweep(tmp_path):
    assert _parity(restart_rescan_and_sweep, tmp_path)[:2] == [[0, 1, 2],
                                                              False]


def retention(pkg, d):
    root, lay = str(d), _layout(pkg)
    coord = _coord(pkg, root, keep=2)
    w = _writer(pkg, coord)
    for step in range(4):
        w.save_async(step, _tree(pkg, step + 1.0)).result(timeout=30)
    w.close()
    return [coord.committed_steps(),
            sorted(x for x in os.listdir(root) if lay.parse_step(x))]


def test_retention_keeps_last_k_committed(tmp_path):
    assert _parity(retention, tmp_path) == [
        [2, 3], ["checkpoint_000002", "checkpoint_000003"]]


def epoch_fencing(pkg, d):
    root = str(d)
    coord = _coord(pkg, root)
    e1 = coord.new_epoch()
    coord.begin_save(5, num_shards=2, epoch=e1)
    e2 = coord.new_epoch()
    seen = [coord.shard_complete(5, 0, {"bytes": 1}, epoch=e1),
            coord.latest_committed()]
    w = _writer(pkg, coord, epoch=e2)
    w.save_async(5, _tree(pkg, 9.0)).result(timeout=30)
    w.close()
    seen += [coord.latest_committed(),
             coord.shard_complete(5, 1, {"bytes": 1}, epoch=e1)]
    restored = _ck(pkg).restore_latest(root)
    _equal(restored, _tree(pkg, 9.0))
    return seen


def test_epoch_fencing_discards_stale_attempt(tmp_path):
    assert _parity(epoch_fencing, tmp_path) == [False, None, 5, False]


def aborted_step(pkg, d):
    coord = _coord(pkg, d)
    coord.begin_save(3, num_shards=2, epoch=0)
    coord.shard_failed(3, 0, "disk full", epoch=0)
    with pytest.raises(RuntimeError, match="aborted"):
        coord.begin_save(3, num_shards=2, epoch=0)
    seen = [coord.shard_complete(3, 1, {"bytes": 1}, epoch=0),
            coord.stats()["pending_steps"]]
    e2 = coord.new_epoch()
    w = _writer(pkg, coord, epoch=e2)
    w.save_async(3, _tree(pkg, 4.0)).result(timeout=30)
    w.close()
    return seen + [coord.latest_committed()]


def test_aborted_step_cannot_be_resurrected_by_sibling(tmp_path):
    assert _parity(aborted_step, tmp_path) == [False, [], 3]


def commit_beside_sweep(pkg, d, monkeypatch):
    root, lay = str(d), _layout(pkg)
    coord = _coord(pkg, root)
    real_commit = lay.commit_step_dir
    swept = []

    def commit_with_interleaved_save(c_root, step, manifests, extra=None):
        coord.begin_save(step + 1, num_shards=1, epoch=0)
        swept.append(not os.path.isdir(lay.tmp_dir(c_root, step)))
        return real_commit(c_root, step, manifests, extra=extra)

    monkeypatch.setattr(lay, "commit_step_dir", commit_with_interleaved_save)
    w = _writer(pkg, coord)
    w.save_async(0, _tree(pkg, 1.0)).result(timeout=30)
    w.close()
    monkeypatch.undo()
    final = lay.final_dir(root, 0)
    restored = _ck(pkg).restore_pytree(final)
    _equal(restored, _tree(pkg, 1.0))
    return [swept, coord.latest_committed(), _ck(pkg).is_committed_dir(final)]


def test_commit_survives_concurrent_begin_save_sweep(tmp_path, monkeypatch):
    assert _parity(commit_beside_sweep, tmp_path, monkeypatch) == [
        [False], 0, True]


def none_and_object_leaves(pkg, d):
    ck = _ck(pkg)
    root = str(d / "none_ok")
    coord = _coord(pkg, root)
    tree = {"w": np.ones((4, 2), np.float32), "extra": None,
            "opt": [None, np.float32(2.0)]}
    w = _writer(pkg, coord)
    w.save_async(0, tree).result(timeout=30)
    w.close()
    restored = ck.restore_latest(root)
    coord2 = _coord(pkg, str(d / "obj"))
    w2 = _writer(pkg, coord2)
    exc = w2.save_async(0, {"bad": object()}).exception(timeout=30)
    w2.close()
    return [bits(restored), type(exc).__name__, coord2.latest_committed()]


def test_none_leaf_roundtrips_and_object_leaf_rejected(tmp_path):
    tree, exc, latest = _parity(none_and_object_leaves, tmp_path)
    assert tree["extra"] is None and tree["opt"][0] is None
    assert (exc, latest) == ("TypeError", None)


def aborted_set_pruned(pkg, d):
    coord = _coord(pkg, d)
    coord.begin_save(0, num_shards=2, epoch=0)
    coord.shard_failed(0, 0, "disk full", epoch=0)
    before = coord.stats()["aborted_entries"]
    w = _writer(pkg, coord)
    w.save_async(1, _tree(pkg, 1.0)).result(timeout=30)
    w.close()
    return [before, coord.latest_committed(),
            coord.stats()["aborted_entries"]]


def test_aborted_set_pruned_after_commit(tmp_path):
    assert _parity(aborted_set_pruned, tmp_path) == [1, 1, 0]


TrainState = collections.namedtuple("TrainState", ["w", "count"])


def pickle_skeleton(pkg, d):
    tree = TrainState(w=np.arange(8, dtype=np.float32), count=np.int32(4))
    coord = _coord(pkg, d)
    w = _writer(pkg, coord)
    w.save_async(0, tree).result(timeout=30)
    w.close()
    restored = _ck(pkg).restore_latest(str(d))
    files = sorted(os.listdir(os.path.join(
        _layout(pkg).final_dir(str(d), 0), "shard_00000")))
    return [type(restored).__name__, bits(list(restored)), files]


def test_skeleton_pickle_fallback_for_custom_pytree_nodes(tmp_path):
    name, leaves, files = _parity(pickle_skeleton, tmp_path)
    assert name == "TrainState" and int(leaves[1]) == 4
    assert "skeleton.pkl" in files


# ------------------------------------------------------------ replica tier

def memory_restore(pkg, base):
    ck, lay = _ck(pkg), _layout(pkg)
    d = os.path.join(base, pkg.__name__)
    coord = pkg.remote(ck.CheckpointCoordinator).remote(
        os.path.join(d, "primary"), replica_steps=2, replicate_to_peer=False)
    writers = [ck.ShardWriter(coord, shard_id=i, world_size=2)
               for i in range(2)]
    for step in range(2):
        for h in [w.save_async(step, _tree(pkg, step + 1.0))
                  for w in writers]:
            h.result(timeout=60)
    for w in writers:
        w.drain(timeout=60)
        w.close()
    src = pkg.get(coord.restore_source.remote())
    payloads = {sid: pkg.get(wrapped["ref"])
                for sid, wrapped in src["replicas"]["refs"].items()}
    in_memory = lay.assemble_from_payloads(payloads)
    _equal(in_memory, _tree(pkg, 2.0))
    path = ck.materialize_from_payloads(os.path.join(d, "recovered"), 1,
                                        payloads)
    restored = ck.restore_pytree(path, _source="memory")
    _equal(restored, _tree(pkg, 2.0))
    return {"step": src["step"], "replica_step": src["replicas"]["step"],
            "shards": sorted(payloads), "in_memory": bits(in_memory),
            "committed": ck.is_committed_dir(path),
            "restored": bits(restored)}


def test_replica_tier_memory_restore(tmp_path):
    ref, port = both(memory_restore, str(tmp_path))
    assert_same(bits(ref), bits(port), atol=0)
    assert (port["step"], port["replica_step"], port["shards"]) == (1, 1,
                                                                   [0, 1])


def replica_trim(pkg, base):
    d = os.path.join(base, pkg.__name__)
    coord = _coord(pkg, d, replica_steps=1)
    w = _writer(pkg, coord, replicate=True)
    for step in range(3):
        w.save_async(step, _tree(pkg, step + 1.0)).result(timeout=30)
    w.close()
    stats = coord.stats()
    return [stats["committed_steps"], stats["replica_steps"]]


def test_replica_tier_trims_to_last_k(tmp_path):
    ref, port = both(replica_trim, str(tmp_path))
    assert ref == port == [[0, 1, 2], [2]]


def peer_holder_on_one_node(pkg):
    replica = importlib.import_module(pkg.__name__ + ".checkpoint.replica")
    return replica.start_peer_holder()


def test_peer_holder_none_on_one_node():
    """The single-node half of test_peer_holder_placement_and_fetch: no
    node to put a holder on, so none starts (the second node waits for
    ROADMAP.md, Queue 1 item 13.8a)."""
    assert both(peer_holder_on_one_node) == (None, None)


def test_replica_holder_keeps_what_it_is_given():
    """The holder's own bookkeeping, called directly as the reference's
    tests also use the class."""
    from ray_tpu_torch.checkpoint import ReplicaHolder

    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        holder = ReplicaHolder()
        payload = {"doc": {"leaves": []}, "skeleton": None, "kind": "json",
                   "arrays": {"leaf_0": np.ones(4, np.float32)},
                   "shard_id": 0, "step": 3}
        holder.hold(3, 0, {"ref": ray_tpu_torch.put(payload)})
        assert holder.held() == [(3, 0)]
        np.testing.assert_allclose(holder.fetch(3)[0]["arrays"]["leaf_0"],
                                   1.0)
        holder.trim([])
        assert holder.held() == []
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------- restore at another world size

def two_shards_at_worlds(pkg, d):
    """Written by world size 2; restored at world size 1, then written
    again by world size 4 from the restored tree and restored."""
    ck, lay = _ck(pkg), _layout(pkg)
    root = str(d / "two")
    coord = _coord(pkg, root)
    tree = {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
            "b": np.float32(3.0), "mu": _tree(pkg, 1.0)["mu"]}
    for i in range(2):
        w = _writer(pkg, coord, i, 2)
        w.save_async(0, tree).result(timeout=30)
        w.close()
    at_one = ck.restore_latest(root)
    _equal(at_one, tree)
    root4 = str(d / "four")
    coord4 = _coord(pkg, root4)
    for i in range(4):
        w = _writer(pkg, coord4, i, 4)
        w.save_async(0, at_one).result(timeout=30)
        w.close()
    doc, _, _ = lay.read_skeleton(lay.final_dir(root4, 0))
    at_four = ck.restore_latest(root4)
    _equal(at_four, tree)
    return [bits(at_one), [m["partition"] for m in doc["leaves"]],
            bits(at_four)]


def test_restore_two_shards_at_world_sizes_one_and_four(tmp_path):
    _, parts, _ = _parity(two_shards_at_worlds, tmp_path)
    # Sorted leaves: b (a scalar), mu (8, 2), w (8, 4).
    assert [p["kind"] for p in parts] == ["replicated", "sharded", "sharded"]
    assert parts[2]["count"] == 4


def test_restore_onto_a_mesh_waits_for_the_mesh_axes(tmp_path):
    from ray_tpu_torch.checkpoint import restore_latest

    coord = _coord(ray_tpu_torch, tmp_path)
    w = _writer(ray_tpu_torch, coord)
    w.save_async(0, {"w": np.ones(4, np.float32)}).result(timeout=30)
    w.close()
    with pytest.raises(NotImplementedError, match="item 3"):
        restore_latest(str(tmp_path), mesh=object())


def world_down_to_one(pkg, d):
    coord = _coord(pkg, d)
    tree = _tree(pkg, 5.0)
    for i in range(2):
        w = _writer(pkg, coord, i, 2)
        w.save_async(0, tree).result(timeout=30)
        w.close()
    restored = _ck(pkg).restore_latest(str(d))
    _equal(restored, tree)
    return bits(restored)


def test_elastic_restore_world_size_down_to_one(tmp_path):
    _parity(world_down_to_one, tmp_path)
    # The port's leaves are host tensors (the reference's numpy arrays).
    restored = _ck(ray_tpu_torch).restore_latest(
        str(tmp_path / "ray_tpu_torch"))
    assert isinstance(restored["w"], torch.Tensor)
    assert restored["w"].device.type == "cpu"
    assert restored["mu"].dtype == torch.bfloat16


def test_restore_with_a_template_takes_its_devices_and_dtypes(tmp_path):
    """A template leaf gives its device and dtype, a Python scalar its
    type; the structure must match."""
    from ray_tpu_torch.checkpoint import restore_latest

    coord = _coord(ray_tpu_torch, tmp_path)
    w = _writer(ray_tpu_torch, coord)
    state = {"p": torch.arange(6.0).reshape(3, 2), "count": 7,
             "mu": torch.ones(3).to(torch.bfloat16)}
    w.save_async(0, state).result(timeout=30)
    w.close()
    template = {"p": torch.zeros(3, 2, dtype=torch.float64), "count": 0,
                "mu": torch.zeros(3, dtype=torch.bfloat16)}
    got = restore_latest(str(tmp_path), template)
    assert got["p"].dtype == torch.float64 and got["count"] == 7
    assert isinstance(got["count"], int)
    assert torch.equal(got["mu"], state["mu"])
    with pytest.raises(ValueError, match="does not match"):
        restore_latest(str(tmp_path), {"p": template["p"]})


# ------------------------------------------- regression: manager + tree IO

def _train_ckpt(pkg):
    return importlib.import_module(pkg.__name__ + ".train.checkpoint")


def manager_rescan(pkg, d):
    tc = _train_ckpt(pkg)
    storage = str(d)
    m1 = tc.CheckpointManager(storage, num_to_keep=5, score_attribute="score")
    for i in range(3):
        src = tempfile.mkdtemp()
        with open(os.path.join(src, "data.json"), "w") as f:
            json.dump({"step": i}, f)
        m1.register(tc.Checkpoint(src), {"score": float(i)})
    m2 = tc.CheckpointManager(storage, num_to_keep=5, score_attribute="score")
    seen = [m2.latest_checkpoint().get_metadata()["index"],
            m2.best_checkpoint().get_metadata()["metrics"]["score"]]
    src = tempfile.mkdtemp()
    with open(os.path.join(src, "data.json"), "w") as f:
        json.dump({"step": 3}, f)
    c4 = m2.register(tc.Checkpoint(src), {"score": 3.0})
    return seen + [os.path.basename(c4.path)]


def test_checkpoint_manager_rescan_survives_restart(tmp_path):
    assert _parity(manager_rescan, tmp_path) == [3, 2.0, "checkpoint_000004"]


def manager_skips_torn(pkg, d):
    tc, lay = _train_ckpt(pkg), _layout(pkg)
    storage = str(d)
    torn = os.path.join(storage, "checkpoint_000009")
    os.makedirs(os.path.join(torn, lay.shard_dirname(0)))
    seen = [tc.CheckpointManager(storage).latest_checkpoint()]
    coord = _coord(pkg, storage)
    w = _writer(pkg, coord)
    w.save_async(2, _tree(pkg, 1.0)).result(timeout=30)
    w.close()
    latest = tc.CheckpointManager(storage).latest_checkpoint()
    restored = latest.to_pytree()
    _equal(restored, _tree(pkg, 1.0))
    return seen + [os.path.basename(latest.path), bits(restored)]


def test_checkpoint_manager_rescan_skips_torn_sharded_dirs(tmp_path):
    assert _parity(manager_skips_torn, tmp_path)[:2] == [
        None, "checkpoint_000002"]


def manager_never_clobbers(pkg, d):
    tc, lay, ck = _train_ckpt(pkg), _layout(pkg), _ck(pkg)
    storage = str(d)
    m = tc.CheckpointManager(storage, num_to_keep=5)
    coord = _coord(pkg, storage)
    w = _writer(pkg, coord)
    w.save_async(1, _tree(pkg, 7.0)).result(timeout=30)
    w.close()
    committed = lay.final_dir(storage, 1)
    src = tempfile.mkdtemp()
    with open(os.path.join(src, "data.json"), "w") as f:
        json.dump({}, f)
    managed = m.register(tc.Checkpoint(src), {"score": 1.0})
    restored = ck.restore_pytree(committed)
    _equal(restored, _tree(pkg, 7.0))
    return [ck.is_committed_dir(committed), os.path.basename(managed.path)]


def test_manager_register_never_clobbers_committed_sharded_dir(tmp_path):
    assert _parity(manager_never_clobbers, tmp_path) == [
        True, "checkpoint_000002"]


def manager_retention_leaves_committed(pkg, d):
    """Manager retention evicts a coordinator-committed dir from its
    registry but leaves the directory to the coordinator."""
    tc, lay = _train_ckpt(pkg), _layout(pkg)
    storage = str(d)
    coord = _coord(pkg, storage)
    w = _writer(pkg, coord)
    w.save_async(1, _tree(pkg, 1.0)).result(timeout=30)
    w.close()
    m = tc.CheckpointManager(storage, num_to_keep=1)
    src = tempfile.mkdtemp()
    with open(os.path.join(src, "data.json"), "w") as f:
        json.dump({}, f)
    m.register(tc.Checkpoint(src), {})
    return [sorted(os.listdir(storage)),
            os.path.basename(m.latest_checkpoint().path),
            os.path.exists(os.path.join(lay.final_dir(storage, 1),
                                        lay.COMMIT_MARKER))]


def test_manager_retention_leaves_committed_dirs(tmp_path):
    assert _parity(manager_retention_leaves_committed, tmp_path) == [
        ["checkpoint_000001", "checkpoint_000002"], "checkpoint_000002",
        True]


def crash_mid_save(pkg, d, monkeypatch):
    tc = _train_ckpt(pkg)
    path = str(d / "pytree")
    tc.save_pytree({"w": np.ones(4, np.float32)}, path)

    def crashing(tree, p):
        os.makedirs(p, exist_ok=True)
        with open(os.path.join(p, "partial"), "w") as f:
            f.write("garbage")
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(tc, "_orbax_save" if pkg is ray_tpu
                        else "_torch_save", crashing)
    with pytest.raises(RuntimeError, match="mid-save"):
        tc.save_pytree({"w": np.zeros(4, np.float32)}, path)
    monkeypatch.undo()
    kept = np.asarray(tc.load_pytree(path)["w"])
    tc.save_pytree({"w": np.full(4, 2.0, np.float32)}, path)
    return [kept, os.path.exists(path + ".tmp"),
            np.asarray(tc.load_pytree(path)["w"])]


def test_save_pytree_crash_mid_save_preserves_previous(tmp_path, monkeypatch):
    pytest.importorskip("orbax.checkpoint")
    kept, tmp_left, new = _parity(crash_mid_save, tmp_path, monkeypatch)
    assert kept.tolist() == [1.0] * 4 and not tmp_left
    assert new.tolist() == [2.0] * 4


# --------------------------------------------------- trainer happy path

def trainer_async_save(pkg, base):
    train = importlib.import_module(pkg.__name__ + ".train")
    lay = _layout(pkg)
    storage = os.path.join(base, pkg.__name__)
    if pkg is ray_tpu:
        import jax.numpy as jnp

        def loop(config):
            for it in range(4):
                train.report({"step": it}, checkpoint={
                    "step": jnp.asarray(it), "w": jnp.full((8, 2), float(it)),
                    "mu": jnp.full((4,), it / 3, jnp.bfloat16)})
        trainer_cls, scaling = train.JaxTrainer, train.ScalingConfig(
            num_workers=2)
    else:
        def loop(config):
            for it in range(4):
                train.report({"step": it}, checkpoint={
                    "step": torch.tensor(it, dtype=torch.int32),
                    "w": torch.full((8, 2),
                                                              float(it)),
                    "mu": torch.full((4,), it / 3).to(torch.bfloat16)})
        trainer_cls, scaling = train.CudaTrainer, train.ScalingConfig(
            num_workers=2, use_gpu=False)
    result = trainer_cls(loop, scaling_config=scaling, run_config=(
        train.RunConfig(name="async_ckpt", storage_path=storage,
                        checkpoint_config=train.CheckpointConfig(
                            num_to_keep=2, async_save=True)))).fit()
    root = os.path.join(storage, "async_ckpt", "checkpoints", "sharded")
    return {"error": result.error, "latest": lay.latest_committed_step(root),
            "committed": lay.list_committed_steps(root),
            "restored": bits(result.checkpoint.to_pytree())}


def test_trainer_async_save_commits_and_resumes(tmp_path):
    ref, port = both(trainer_async_save, str(tmp_path))
    assert_same(ref, port, atol=0)
    assert port["error"] is None and port["committed"] == [2, 3]
    assert int(port["restored"]["step"]) == 3


@pytest.mark.slow
def test_async_save_blocks_under_quarter_of_sync(tmp_path):
    """The reference's acceptance envelope with the port's writer on host
    tensors: 4 saves of a 64 MB state, the median async block at most a
    quarter of the median sync save (on the card: chip_smoke.py's
    ``train_fit_e`` gate)."""
    import statistics
    import time

    from ray_tpu_torch.checkpoint import CheckpointCoordinator, ShardWriter

    state = {"w": torch.randn(16, 1 << 20)}
    coord = CheckpointCoordinator(str(tmp_path / "a"), keep=2,
                                  replicate_to_peer=False)
    w = ShardWriter(coord, replicate=False)
    blocks, syncs = [], []
    for step in range(4):
        blocks.append(w.save_async(step, state).block_seconds)
        w.drain(timeout=120)
    sync_coord = CheckpointCoordinator(str(tmp_path / "s"), keep=2,
                                       replicate_to_peer=False)
    ws = ShardWriter(sync_coord, replicate=False)
    for step in range(4):
        t0 = time.monotonic()
        ws.save_sync(step, state)
        syncs.append(time.monotonic() - t0)
    w.close()
    ws.close()
    ratio = statistics.median(blocks) / statistics.median(syncs)
    assert ratio <= 0.25, (blocks, syncs)


# ------------------------------------------------- across the two packages

def _saved_by(pkg, root, tree, world=2):
    coord = _coord(pkg, root)
    for i in range(world):
        w = _writer(pkg, coord, i, world)
        w.save_async(0, tree).result(timeout=30)
        w.close()
    return _layout(pkg).final_dir(str(root), 0)


def test_reference_step_restores_through_the_port(tmp_path):
    step = _saved_by(ray_tpu, tmp_path, _tree(ray_tpu, 3.0))
    got = _ck(ray_tpu_torch).restore_pytree(step)
    assert got["mu"].dtype == torch.bfloat16
    assert got["w"].dtype == torch.float32
    _equal(got, _tree(ray_tpu_torch, 3.0))


def test_port_step_assembles_through_the_reference(tmp_path):
    from ray_tpu.checkpoint import layout as ref_layout

    port_step = _saved_by(ray_tpu_torch, tmp_path / "port",
                          _tree(ray_tpu_torch, 3.0))
    ref_step = _saved_by(ray_tpu, tmp_path / "ref", _tree(ray_tpu, 3.0))
    got = ref_layout.assemble_tree(port_step)
    own = ref_layout.assemble_tree(ref_step)
    assert own["mu"].dtype == np.dtype("V2")  # the reference's own fault
    assert got["mu"].tobytes() == own["mu"].tobytes()
    for key in ("w", "b"):
        assert got[key].dtype == own[key].dtype
        np.testing.assert_array_equal(got[key], own[key])
    np.testing.assert_array_equal(got["opt"][0], own["opt"][0])
    np.testing.assert_array_equal(got["opt"][1]["m"], own["opt"][1]["m"])


def test_both_writers_give_the_same_skeleton(tmp_path):
    docs = []
    for pkg in (ray_tpu, ray_tpu_torch):
        step = _saved_by(pkg, tmp_path / pkg.__name__, _tree(pkg, 1.0))
        with open(os.path.join(step, "shard_00000", "skeleton.json")) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    mu = docs[1]["skeleton"]["k"].index("mu")
    assert docs[1]["leaves"][mu]["dtype"] == "bfloat16"


def test_every_bf16_pattern_round_trips_bit_for_bit(tmp_path):
    """All 65,536 bfloat16 bit patterns (NaNs, infinities, -0 and
    subnormals among them), written in two shards and restored as
    torch.bfloat16."""
    patterns = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).reshape(256, 256)
    step = _saved_by(ray_tpu_torch, tmp_path, {"mu": patterns})
    got = _ck(ray_tpu_torch).restore_pytree(step)["mu"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), patterns.view(torch.int16))


def test_pinned_pool_never_holds_more_than_its_depth(monkeypatch):
    """Threads (more than cores, a short switch interval) take and give
    back snapshot buffers of three sizes: at no time are more than
    ``PINNED_BUFFERS`` leased, and every one comes back."""
    import sys
    import threading

    from ray_tpu_torch.checkpoint.writer import PINNED_BUFFERS, PinnedPool

    pool = PinnedPool()
    made = []

    def allocate(nbytes):  # the card's page-locked memory, faked
        made.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(pool, "_allocate", allocate)
    guard = threading.Lock()
    state = {"live": 0, "peak": 0, "done": 0}

    def worker(i):
        for k in range(200):
            nbytes = 64 * (1 + (i + k) % 3)
            buf = pool.acquire(nbytes)
            with guard:
                state["live"] += 1
                state["peak"] = max(state["peak"], state["live"])
            assert buf.numel() >= nbytes
            with guard:
                state["live"] -= 1
            pool.release(buf)
        with guard:
            state["done"] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and state["done"] == 8
    assert state["peak"] <= PINNED_BUFFERS
    assert pool._leased == 0 and len(pool._free) <= PINNED_BUFFERS


def test_pinned_pool_counts_the_wait_for_a_buffer(monkeypatch):
    """A save that finds every buffer leased waits for a release, and the
    wait lands in ``wait_seconds`` (what ``SaveHandle.wait_seconds``
    reports); acquires that find a buffer free add nothing."""
    import threading

    from ray_tpu_torch.checkpoint.writer import PINNED_BUFFERS, PinnedPool

    pool = PinnedPool()
    monkeypatch.setattr(pool, "_allocate", lambda nbytes: torch.empty(
        nbytes, dtype=torch.uint8))
    held = [pool.acquire(64) for _ in range(PINNED_BUFFERS)]
    assert pool.wait_seconds == 0.0
    got = []
    waiter = threading.Thread(target=lambda: got.append(pool.acquire(64)))
    waiter.start()
    time.sleep(0.2)
    assert not got
    pool.release(held.pop())
    waiter.join(timeout=10)
    assert len(got) == 1 and 0.15 <= pool.wait_seconds < 10


def test_shard_file_entries_are_what_np_savez_writes(tmp_path):
    """The port writes leaves.npz from each array's memory; every entry is
    byte for byte the one ``np.savez`` writes (C and Fortran order, 0-d,
    empty, strided, bool, strings, bf16 bits)."""
    import zipfile

    from ray_tpu_torch.checkpoint import layout

    rng = np.random.default_rng(0)
    arrays = {"leaf_0": rng.normal(size=(3, 4)).astype(np.float32),
              "leaf_1": np.float32(3), "leaf_2": np.zeros((0, 3)),
              "leaf_3": np.arange(6, dtype=np.uint16)[::2],
              "leaf_4": np.array(["ab", "c"]),
              "leaf_5": np.array([True, False]),
              "leaf_6": np.arange(12.0).reshape(3, 4).T,
              "leaf_7": np.arange(24.0).reshape(2, 3, 4)[:, ::2]}
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "np.npz")
    layout._write_npz(ours, arrays)
    np.savez(theirs, **arrays)
    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist()
        for name in b.namelist():
            assert a.read(name) == b.read(name), name
    assert os.path.getsize(ours) == os.path.getsize(theirs)


@pytest.mark.parametrize("arrays", ["none", "one", "mixed"])
def test_shard_manifest_crc_is_the_files_crc(tmp_path, arrays):
    """The manifest's ``crc32`` is built from the zip entries' own CRCs
    (the data is not read back), and equals ``zlib.crc32`` of the whole
    ``leaves.npz``, as the reference computes it over its in-memory file;
    the combine step agrees with zlib on random splits."""
    import zlib

    from ray_tpu_torch.checkpoint import layout

    rng = np.random.default_rng(3)
    for _ in range(50):
        a = rng.bytes(int(rng.integers(0, 5000)))
        b = rng.bytes(int(rng.integers(0, 5000)))
        assert layout._crc32_combine(zlib.crc32(a), zlib.crc32(b),
                                     len(b)) == zlib.crc32(a + b)
    tree = {"none": {"s": 3, "t": "x"},
            "one": {"w": rng.normal(size=(64, 33)).astype(np.float32)},
            "mixed": {"w": rng.normal(size=(8, 5)),
                      "mu": torch.from_numpy(rng.normal(size=(4, 9)).astype(
                          np.float32)).to(torch.bfloat16),
                      "f": np.asfortranarray(rng.normal(size=(5, 6))),
                      "e": np.zeros((0, 2)), "n": np.int64(7)}}[arrays]
    doc, skeleton, kind, arr = layout.build_shard(tree, 0, 1)
    manifest = layout.write_shard(str(tmp_path), 0, doc, skeleton, kind,
                                  arr, 1)
    with open(tmp_path / layout.shard_dirname(0) / "leaves.npz", "rb") as f:
        assert manifest["crc32"] == zlib.crc32(f.read())


def test_restore_from_payloads_equals_the_committed_dir(tmp_path):
    """The memory tier's restore: two shards' replica payloads assemble
    into the tree that ``restore_pytree`` reads from the same step's
    committed dir, bf16 bit for bit, with and without a template; writing
    into the restored leaves leaves the payloads whole; a
    ``ReplicaCheckpoint`` reads the payloads, not its dir."""
    from ray_tpu_torch import checkpoint as ck
    from ray_tpu_torch.checkpoint import layout
    from ray_tpu_torch.train.checkpoint import ReplicaCheckpoint

    rng = np.random.default_rng(11)
    tree = {"w": torch.from_numpy(rng.normal(size=(6, 5)).astype(
                np.float32)),
            "mu": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                np.float32)).to(torch.bfloat16),
            "b": torch.arange(3, dtype=torch.int64), "step": 7}
    payloads, manifests = {}, {}
    tmp = layout.tmp_dir(str(tmp_path), 7)
    for sid in range(2):
        doc, skeleton, kind, arrays = layout.build_shard(tree, sid, 2)
        payloads[sid] = {"doc": doc, "skeleton": skeleton, "kind": kind,
                         "arrays": arrays, "shard_id": sid, "step": 7}
        manifests[sid] = layout.write_shard(tmp, sid, doc, skeleton, kind,
                                            arrays, 7)
    path = layout.commit_step_dir(str(tmp_path), 7, manifests)
    kept = {sid: {k: a.copy() for k, a in p["arrays"].items()}
            for sid, p in payloads.items()}
    template = {"step": 0, "w": torch.zeros(6, 5), "b": torch.zeros(3),
                "mu": torch.zeros(4, 3, dtype=torch.bfloat16)}
    for tmpl in (None, template):
        got = ck.restore_from_payloads(payloads, tmpl)
        want = ck.restore_pytree(path, tmpl)
        assert list(got) == list(want)
        for k in want:
            if isinstance(want[k], torch.Tensor):
                assert got[k].dtype == want[k].dtype
                assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                                   want[k].reshape(-1).view(torch.uint8)), k
            else:
                assert got[k] == want[k]
        got["w"].add_(1.0)
        got["mu"].add_(1.0)
    for sid, p in payloads.items():
        for k, a in p["arrays"].items():
            assert np.array_equal(a, kept[sid][k])
    shutil.rmtree(path)  # the handle reads the payloads alone
    handle = ReplicaCheckpoint(path, payloads)
    assert torch.equal(handle.to_pytree()["w"], tree["w"])
