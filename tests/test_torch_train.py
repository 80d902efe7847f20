"""The port's Train library (ray_tpu_torch.train) against the reference's
(ray_tpu.train) on the cases of tests/test_train.py, tests/test_torch_trainer.py
and the Trainer-side ingest cases of tests/test_data_ingest.py and
tests/test_data.py.

Each case runs on both packages, one after the other. The loops compute the
same functions on the same numpy inputs and weights — the reference's with
JAX and optax, the port's with torch — so what each reports must agree:
integers exactly, losses and weights within 1e-5 (fp32 sums in other
orders; Adam steps within 1e-4). The reference's ``JaxTrainer`` runs on its
CPU devices; the port's ``CudaTrainer`` is given ``use_gpu=False``, as a
caller that wants the CPU says. TorchTrainer's ranks are gloo processes on
both sides. The port's own cases follow: checkpoints (a bit-exact round
trip onto the template's devices and dtypes, a crash mid-save), the
refusals of what is not ported, the card check, the run registry's HTTP
route and the launch from one worker process.
"""

import json
import os
import tempfile
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both

LOSS_TOL = 1e-5


def _train(pkg):
    import importlib

    return importlib.import_module(pkg.__name__ + ".train")


def _trainer(pkg):
    return _train(pkg).JaxTrainer if pkg is ray_tpu else _train(pkg).CudaTrainer


def _scaling(pkg, **kw):
    if pkg is ray_tpu_torch:
        kw.setdefault("use_gpu", False)
    return _train(pkg).ScalingConfig(**kw)


def _make_data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 784)).astype(np.float32)
    w = rng.normal(size=(784, 10)).astype(np.float32)
    y = np.argmax(x @ w + rng.normal(size=(n, 10)) * 0.1, axis=-1).astype(np.int32)
    return x, y


def _mlp_init():
    """The reference MLP's weights (784-128-64-10), as numpy."""
    import jax

    from ray_tpu.models import mlp

    return jax.tree.map(np.asarray, mlp.init_params(jax.random.key(0)))


def _torch_mlp():
    """(loss, accuracy) of the reference MLP's function, in torch."""
    import torch.nn.functional as F

    def forward(params, x):
        for layer in params[:-1]:
            x = F.relu(x @ layer["w"] + layer["b"])
        return x @ params[-1]["w"] + params[-1]["b"]

    def loss(params, x, y):
        return F.cross_entropy(forward(params, x), y)

    def accuracy(params, x, y):
        return (forward(params, x).argmax(-1) == y).float().mean()

    return loss, accuracy


# ------------------------------------------------- tests/test_train.py cases
def single_worker_mnist_style(pkg, init):
    """BASELINE config 1: single-worker MLP classification train."""
    train = _train(pkg)
    if pkg is ray_tpu:
        def loop(config):
            import jax
            import optax

            from ray_tpu.models import mlp

            x, y = _make_data()
            params = jax.tree.map(jax.numpy.asarray, init)
            opt = optax.adam(1e-3)
            opt_state = opt.init(params)

            @jax.jit
            def step(params, opt_state, xb, yb):
                loss, grads = jax.value_and_grad(mlp.loss_fn)(params, xb, yb)
                updates, opt_state = opt.update(grads, opt_state)
                return optax.apply_updates(params, updates), opt_state, loss

            for epoch in range(config["epochs"]):
                for i in range(0, len(x), 128):
                    params, opt_state, loss = step(params, opt_state,
                                                   x[i:i + 128], y[i:i + 128])
                acc = float(mlp.accuracy(params, x, y))
                train.report({"epoch": epoch, "loss": float(loss),
                              "accuracy": acc})
    else:
        def loop(config):
            loss_fn, accuracy = _torch_mlp()
            x, y = (torch.from_numpy(a) for a in _make_data())
            y = y.long()
            params = [{k: torch.tensor(v, requires_grad=True)
                       for k, v in layer.items()} for layer in init]
            leaves = [p for layer in params for p in layer.values()]
            opt = torch.optim.Adam(leaves, lr=1e-3)
            for epoch in range(config["epochs"]):
                for i in range(0, len(x), 128):
                    opt.zero_grad()
                    loss = loss_fn(params, x[i:i + 128], y[i:i + 128])
                    loss.backward()
                    opt.step()
                with torch.no_grad():
                    acc = float(accuracy(params, x, y))
                train.report({"epoch": epoch, "loss": float(loss.detach()),
                              "accuracy": acc})

    result = _trainer(pkg)(loop, train_loop_config={"epochs": 3},
                           scaling_config=_scaling(pkg, num_workers=1)).fit()
    return [result.error, result.metrics["epoch"],
            result.metrics["accuracy"] > 0.5, len(result.metrics_history),
            [m["loss"] for m in result.metrics_history],
            [m["accuracy"] for m in result.metrics_history]]


def multi_worker_allreduce_training(pkg, init):
    """4 workers, gradient allreduce through the collective group — the DDP
    equivalent (ref: _TorchBackend _setup_torch_process_group + DDP wrap);
    every rank's loss each iteration."""
    train = _train(pkg)
    losses = {}
    if pkg is ray_tpu:
        def loop(config):
            import jax
            import jax.numpy as jnp

            from ray_tpu import collective
            from ray_tpu.models import mlp

            ctx = train.get_context()
            rank, world = ctx.get_world_rank(), ctx.get_world_size()
            x, y = _make_data(256, seed=rank)  # a different shard per worker
            params = jax.tree.map(jnp.asarray, init)  # same init everywhere
            lr = 0.1
            grad_fn = jax.jit(lambda p, x, y: jnp.concatenate(
                [g.ravel() for g in jax.tree.leaves(jax.grad(mlp.loss_fn)(p, x, y))]))

            @jax.jit
            def apply(params, sum_flat):
                avg_flat = sum_flat / world
                leaves, tree = jax.tree.flatten(params)
                out, i = [], 0
                for p in leaves:
                    out.append(p - lr * avg_flat[i:i + p.size].reshape(p.shape))
                    i += p.size
                return jax.tree.unflatten(tree, out)

            loss_j = jax.jit(mlp.loss_fn)
            for it in range(4):
                flat_grads = grad_fn(params, x, y)
                summed = collective.allreduce(flat_grads,
                                              group_name=ctx.collective_group)
                params = apply(params, summed)
                loss = float(loss_j(params, x, y))
                losses[(rank, it)] = loss
                train.report({"iter": it, "rank": rank, "loss": loss})
    else:
        def loop(config):
            from ray_tpu_torch import collective

            loss_fn, _ = _torch_mlp()
            ctx = train.get_context()
            rank, world = ctx.get_world_rank(), ctx.get_world_size()
            x, y = (torch.from_numpy(a) for a in _make_data(256, seed=rank))
            y = y.long()
            # The leaves in the reference's tree order (b before w).
            params = [{k: torch.tensor(layer[k]) for k in sorted(layer)}
                      for layer in init]
            leaves = [p for layer in params for p in layer.values()]
            lr = 0.1
            for it in range(4):
                for p in leaves:
                    p.requires_grad_(True)
                grads = torch.autograd.grad(loss_fn(params, x, y), leaves)
                summed = collective.allreduce(
                    torch.cat([g.reshape(-1) for g in grads]),
                    group_name=ctx.collective_group)
                with torch.no_grad():
                    avg = summed / world
                    i = 0
                    for p in leaves:
                        p.sub_(lr * avg[i:i + p.numel()].view(p.shape))
                        i += p.numel()
                    loss = float(loss_fn(params, x, y))
                losses[(rank, it)] = loss
                train.report({"iter": it, "rank": rank, "loss": loss})

    result = _trainer(pkg)(loop,
                           scaling_config=_scaling(pkg, num_workers=4)).fit()
    return [result.error, result.metrics["iter"], len(result.metrics_history),
            [losses[(r, it)] for r in range(4) for it in range(4)]]


def checkpointing_and_topk(pkg):
    train = _train(pkg)
    storage = tempfile.mkdtemp()
    ones = ((lambda: __import__("jax").numpy.zeros((4,))) if pkg is ray_tpu
            else (lambda: torch.zeros(4)))

    def loop(config):
        params = {"w": ones()}
        for it in range(5):
            params = {"w": params["w"] + 1}
            ckpt = train.Checkpoint.from_pytree(params)
            train.report({"iter": it, "score": float(it)}, checkpoint=ckpt)

    result = _trainer(pkg)(
        loop, scaling_config=_scaling(pkg, num_workers=1),
        run_config=train.RunConfig(
            name="ckpt_test", storage_path=storage,
            checkpoint_config=train.CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score")),
    ).fit()
    restored = np.asarray(result.checkpoint.to_pytree()["w"])
    ckpt_dir = os.path.join(storage, "ckpt_test", "checkpoints")
    kept = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("checkpoint_"))
    return [result.error, restored, kept]


def failure_recovery_restores_checkpoint(pkg):
    """Worker crash -> group restart from the newest checkpoint."""
    train = _train(pkg)
    attempts = {"n": 0}
    scalar = ((lambda v: __import__("jax").numpy.asarray(v)) if pkg is ray_tpu
              else torch.tensor)

    def loop(config):
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            start = int(np.asarray(ckpt.to_pytree()["step"])) + 1
        for it in range(start, 4):
            train.report({"step": it}, checkpoint=train.Checkpoint.from_pytree(
                {"step": scalar(it)}))
            if it == 1 and config["fail_once"] and attempts["n"] == 0:
                attempts["n"] += 1
                raise RuntimeError("simulated worker crash")

    result = _trainer(pkg)(
        loop, train_loop_config={"fail_once": True},
        scaling_config=_scaling(pkg, num_workers=1),
        run_config=train.RunConfig(
            failure_config=train.FailureConfig(max_failures=1)),
    ).fit()
    steps = [m["step"] for m in result.metrics_history]
    return [result.error, result.metrics["step"], steps, attempts["n"]]


def failure_exhausts_budget(pkg):
    train = _train(pkg)

    def loop(config):
        raise ValueError("always fails")

    result = _trainer(pkg)(
        loop, scaling_config=_scaling(pkg, num_workers=1),
        run_config=train.RunConfig(
            failure_config=train.FailureConfig(max_failures=1)),
    ).fit()
    return [result.error is not None, "always fails" in str(result.error)]


def report_outside_session_raises(pkg):
    try:
        _train(pkg).report({"x": 1})
    except RuntimeError:
        return "RuntimeError"
    return None


def _observe_close(ref, port, tol=LOSS_TOL):
    assert_same(ref, port, atol=tol)


@pytest.fixture(scope="module")
def mlp_init():
    return _mlp_init()


def test_single_worker_mnist_style(mlp_init):
    ref, port = both(single_worker_mnist_style, mlp_init)
    assert ref[:4] == [None, 2, True, 3]
    assert port[:4] == ref[:4]
    # optax's adam and torch.optim.Adam: one formula, rounded in two orders.
    _observe_close(ref[4:], port[4:], tol=1e-4)


def test_multi_worker_allreduce_training(mlp_init):
    ref, port = both(multi_worker_allreduce_training, mlp_init)
    assert ref[:3] == [None, 3, 4]
    assert port[:3] == ref[:3]
    _observe_close(ref[3], port[3])


@pytest.mark.parametrize("case", [
    checkpointing_and_topk, failure_recovery_restores_checkpoint,
    failure_exhausts_budget, report_outside_session_raises,
], ids=lambda f: f.__name__)
def test_matches_reference(case):
    ref, port = both(case)
    assert_same(ref, port)


def test_checkpointing_and_topk_restores_the_best():
    ref, port = both(checkpointing_and_topk)
    assert ref[0] is None and len(ref[2]) == 2
    np.testing.assert_array_equal(port[1], np.full(4, 5.0, np.float32))


# ---------------------------------------- tests/test_torch_trainer.py cases
def _ddp_loop(pkg_name):
    def loop(config):
        import importlib

        import torch
        import torch.distributed as dist

        train = importlib.import_module(pkg_name + ".train")
        prepare_model = importlib.import_module(
            pkg_name + ".train.torch_trainer").prepare_model
        ctx = train.get_context()
        torch.manual_seed(0)  # identical init on every rank
        model = prepare_model(torch.nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        g = torch.Generator().manual_seed(1234 + ctx.get_world_rank())
        x = torch.randn(32, 4, generator=g)
        y = x.sum(dim=1, keepdim=True)
        for step in range(config["steps"]):
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(model(x), y)
            loss.backward()  # DDP allreduces gradients across ranks here
            opt.step()
            w = [p.detach().clone() for p in model.parameters()]
            train.report({
                "step": step, "loss": float(loss.detach()),
                "rank": ctx.get_world_rank(),
                "world_size": dist.get_world_size(),
                "weight0": float(w[0].flatten()[0]),
            })

    return loop


def torch_trainer_ddp_two_workers(pkg):
    train = _train(pkg)
    result = train.TorchTrainer(
        _ddp_loop(pkg.__name__), train_loop_config={"steps": 4},
        scaling_config=_scaling(pkg, num_workers=2),
        run_config=train.RunConfig(name="torch_ddp",
                                   storage_path=tempfile.mkdtemp())).fit()
    return [result.error, result.metrics["step"], result.metrics["world_size"],
            bool(np.isfinite(result.metrics["loss"])),
            len(result.metrics_history),
            [(m["loss"], m["weight0"]) for m in result.metrics_history]]


def torch_trainer_gradients_actually_sync(pkg):
    """Ranks see different data; DDP averaging keeps their weights equal.
    Every rank writes its final weights to a file (the history keeps rank
    0 only)."""
    train = _train(pkg)
    out_dir = tempfile.mkdtemp()
    pkg_name = pkg.__name__

    def loop(config):
        import importlib
        import json as _json
        import os as _os

        import torch

        train = importlib.import_module(pkg_name + ".train")
        prepare_model = importlib.import_module(
            pkg_name + ".train.torch_trainer").prepare_model
        ctx = train.get_context()
        torch.manual_seed(0)
        model = prepare_model(torch.nn.Linear(3, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        g = torch.Generator().manual_seed(ctx.get_world_rank())
        x = torch.randn(16, 3, generator=g)  # different per rank
        y = x.mean(dim=1, keepdim=True)
        for _ in range(3):
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            opt.step()
        final = torch.cat([p.detach().flatten() for p in model.parameters()])
        with open(_os.path.join(config["out_dir"],
                                f"rank{ctx.get_world_rank()}.json"), "w") as f:
            _json.dump(final.tolist(), f)
        train.report({"rank": ctx.get_world_rank()})

    result = train.TorchTrainer(
        loop, train_loop_config={"out_dir": out_dir},
        scaling_config=_scaling(pkg, num_workers=2),
        run_config=train.RunConfig(name="torch_sync",
                                   storage_path=tempfile.mkdtemp())).fit()
    w0 = json.load(open(f"{out_dir}/rank0.json"))
    w1 = json.load(open(f"{out_dir}/rank1.json"))
    return [result.error, np.float32(w0), np.float32(w1)]


def _solo(rank):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(16, 3, generator=g)
    y = x.mean(dim=1, keepdim=True)
    for _ in range(3):
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.step()
    return torch.cat([p.detach().flatten() for p in model.parameters()]).tolist()


def test_torch_trainer_ddp_two_workers():
    ref, port = both(torch_trainer_ddp_two_workers)
    assert ref[:5] == [None, 3, 2, True, 4]
    assert port[:5] == ref[:5]
    _observe_close(ref[5], port[5])


def test_torch_trainer_gradients_actually_sync():
    ref, port = both(torch_trainer_gradients_actually_sync)
    for obs in (ref, port):
        assert obs[0] is None
        np.testing.assert_allclose(obs[1], obs[2], rtol=1e-6)
    _observe_close(ref, port)
    # Negative control: without DDP the same per-rank data diverges.
    assert not np.allclose(_solo(0), _solo(1))


# ---------------------------------------- Trainer-side streaming ingest
def streaming_default_trainer_path(pkg):
    """DatasetConfig defaults: datasets= flow through StreamingIngest and
    get_dataset_shard returns an IngestShard."""
    import importlib

    data = importlib.import_module(pkg.__name__ + ".data")
    train = _train(pkg)
    ds = data.range(48, parallelism=6).map_batches(
        lambda b: {"x": b["id"].astype(np.float64)})
    seen = {}

    def loop(config):
        shard = train.get_dataset_shard("train")
        seen["type"] = type(shard).__name__
        seen["dcfg"] = train.get_dataset_config().streaming
        total = sum(float(np.sum(b["x"]))
                    for b in shard.iter_batches(batch_size=8))
        train.report({"total": total})

    trainer = _trainer(pkg)(loop, scaling_config=_scaling(pkg, num_workers=1),
                            datasets={"train": ds})
    result = trainer.fit()
    return [result.error, seen, result.metrics["total"],
            trainer.streaming_ingests["train"].exhausted()]


def streaming_false_keeps_legacy_split(pkg):
    import importlib

    data = importlib.import_module(pkg.__name__ + ".data")
    train = _train(pkg)
    ds = data.range(48, parallelism=6)
    seen = {}

    def loop(config):
        seen["type"] = type(train.get_dataset_shard("train")).__name__
        count = sum(len(b["id"])
                    for b in train.get_dataset_shard("train").iter_batches(
                        batch_size=8))
        train.report({"count": count})

    result = _trainer(pkg)(
        loop, scaling_config=_scaling(pkg, num_workers=1),
        datasets={"train": ds},
        dataset_config=train.DatasetConfig(streaming=False)).fit()
    return [result.error, seen, result.metrics["count"]]


def dataset_with_train_ingest(pkg):
    """Two workers claim source shards; allreducing the per-worker totals
    shows every row reached exactly one worker."""
    import importlib

    data = importlib.import_module(pkg.__name__ + ".data")
    col = importlib.import_module(pkg.__name__ + ".collective")
    train = _train(pkg)
    ds = data.range(64).map_batches(lambda b: {"x": b["id"].astype(np.float32)})

    def loop(config):
        ctx = train.get_context()
        total, count = 0.0, 0
        for batch in train.get_dataset_shard("train").iter_batches(batch_size=8):
            total += float(batch["x"].sum())
            count += len(batch["x"])
        vec = np.asarray(col.allreduce(np.float32([count, total]),
                                       group_name=ctx.collective_group))
        train.report({"total": float(vec[1]), "count": int(vec[0])})

    trainer = _trainer(pkg)(loop, scaling_config=_scaling(pkg, num_workers=2),
                            datasets={"train": ds})
    result = trainer.fit()
    audit = trainer.streaming_ingests["train"].audit(0)
    return [result.error, result.metrics, audit["double_trained"],
            audit["untrained"]]


@pytest.mark.parametrize("case", [
    streaming_default_trainer_path, streaming_false_keeps_legacy_split,
    dataset_with_train_ingest,
], ids=lambda f: f.__name__)
def test_trainer_ingest_matches_reference(case):
    ref, port = both(case)
    assert ref[0] is None
    assert_same(ref, port)


# ----------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_onto_the_template():
    """A tree saved from the port loads back bit for bit, each tensor on its
    template leaf's device and dtype; without a template, on the host."""
    from ray_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(0)
    tree = {
        "params": {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
            np.float32)),
            "mu": torch.from_numpy(rng.standard_normal(5).astype(
                np.float32)).to(torch.bfloat16)},
        "ids": [torch.arange(3), (torch.tensor(2.5, dtype=torch.float64),)],
        "count": 7,
        "host": rng.standard_normal(2).astype(np.float32),
    }
    path = os.path.join(tempfile.mkdtemp(), "pytree")
    ckpt.save_pytree(tree, path)
    template = {"params": {"w": torch.empty(0), "mu": torch.empty(
        0, dtype=torch.bfloat16)}, "ids": [torch.empty(0, dtype=torch.long),
                                           (torch.empty(0, dtype=torch.float64),)],
        "count": 0, "host": None}
    back = ckpt.load_pytree(path, template)
    for got, want in ((back["params"]["w"], tree["params"]["w"]),
                      (back["params"]["mu"], tree["params"]["mu"]),
                      (back["ids"][0], tree["ids"][0]),
                      (back["ids"][1][0], tree["ids"][1][0])):
        assert got.dtype == want.dtype and got.device == want.device
        assert got.reshape(-1).view(torch.uint8).tolist() == \
            want.reshape(-1).view(torch.uint8).tolist()
    assert isinstance(back["ids"][1], tuple) and back["count"] == 7
    np.testing.assert_array_equal(np.asarray(back["host"]), tree["host"])
    plain = ckpt.load_pytree(path)
    assert plain["params"]["mu"].dtype == torch.bfloat16


def test_checkpoint_of_device_tensors_saves_host_copies(monkeypatch):
    """Every tensor leaf is moved to the host before torch.save, so the file
    names no device (a checkpoint saved on the card loads on the CPU)."""
    from ray_tpu_torch.train import checkpoint as ckpt

    seen = []
    real = ckpt._torch_save

    def spy(tree, p):
        seen.extend(tree.values())
        real(tree, p)

    monkeypatch.setattr(ckpt, "_torch_save", spy)
    path = os.path.join(tempfile.mkdtemp(), "pytree")
    w = torch.ones(2, requires_grad=True)
    ckpt.save_pytree({"w": w * 2}, path)
    assert seen[0].device.type == "cpu" and not seen[0].requires_grad


def test_save_pytree_crash_mid_save_preserves_previous(tmp_path, monkeypatch):
    """save_pytree writes a tmp sibling, then renames: a crash mid-save
    leaves the previous checkpoint whole (the reference's ``_orbax_save``
    case, tests/test_checkpoint_subsystem.py, with the port's write)."""
    from ray_tpu_torch.train import checkpoint as tckpt

    path = str(tmp_path / "pytree")
    tckpt.save_pytree({"w": np.ones(4, np.float32)}, path)

    def crashing(tree, p):
        os.makedirs(p, exist_ok=True)
        with open(os.path.join(p, "partial"), "w") as f:
            f.write("garbage")
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(tckpt, "_torch_save", crashing)
    with pytest.raises(RuntimeError, match="mid-save"):
        tckpt.save_pytree({"w": np.zeros(4, np.float32)}, path)
    monkeypatch.undo()
    # The previous checkpoint is intact...
    np.testing.assert_allclose(np.asarray(tckpt.load_pytree(path)["w"]), 1.0)
    # ...and the next save reclaims the stale tmp and lands normally.
    tckpt.save_pytree({"w": np.full(4, 2.0, np.float32)}, path)
    assert not os.path.exists(path + ".tmp")
    np.testing.assert_allclose(np.asarray(tckpt.load_pytree(path)["w"]), 2.0)


def test_committed_sharded_dir_waits_for_the_checkpoint_package(tmp_path):
    """A committed sharded dir restores through the checkpoint package
    (it waited for it until the package was ported); a dir that only looks
    committed, a marker without shards, does not restore."""
    from ray_tpu_torch.checkpoint import CheckpointCoordinator, ShardWriter
    from ray_tpu_torch.train import Checkpoint

    coord = CheckpointCoordinator(str(tmp_path), replicate_to_peer=False)
    w = ShardWriter(coord, shard_id=0, world_size=1, replicate=False)
    w.save_async(3, {"w": torch.arange(4.0)}).result(timeout=30)
    w.close()
    got = Checkpoint(str(tmp_path / "checkpoint_000003")).to_pytree()
    assert torch.equal(got["w"], torch.arange(4.0))
    d = tmp_path / "checkpoint_000004"
    d.mkdir()
    (d / "COMMIT").write_text("")
    with pytest.raises(FileNotFoundError):
        Checkpoint(str(d)).to_pytree()


def test_pack_unpack_round_trip():
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.checkpoint import pack_checkpoint, unpack_checkpoint

    c = Checkpoint.from_pytree({"w": torch.arange(4.0)})
    back = unpack_checkpoint(pack_checkpoint(c))
    assert back.path != c.path
    assert back.to_pytree()["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert pack_checkpoint(None) is None and unpack_checkpoint(None) is None


def test_checkpoint_manager_rescans_its_directory(tmp_path):
    """A new manager on the same directory finds the checkpoints and their
    scores (restart-safe), and keeps numbering past them."""
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.checkpoint import CheckpointManager

    root = str(tmp_path / "ckpts")
    m = CheckpointManager(root, num_to_keep=2, score_attribute="acc")
    for acc in (0.1, 0.9, 0.5):
        m.register(Checkpoint.from_pytree({"a": torch.tensor(acc)}),
                   {"acc": acc})
    again = CheckpointManager(root, num_to_keep=2, score_attribute="acc")
    assert sorted(os.listdir(root)) == ["checkpoint_000002",
                                        "checkpoint_000003"]
    assert again.best_checkpoint().path.endswith("checkpoint_000002")
    assert again.latest_checkpoint().path.endswith("checkpoint_000003")
    assert again.register(Checkpoint.from_pytree({"a": torch.tensor(0.0)}),
                          {"acc": 0.0}).path.endswith("checkpoint_000004")


# ----------------------------------------------------------- the port's
def test_what_waits_is_refused_when_built():
    from ray_tpu_torch.train import (
        CheckpointConfig,
        CudaTrainer,
        ElasticConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    # Elastic training is built (it runs on thread ranks:
    # tests/test_torch_train_elastic.py); process ranks refuse it at fit(),
    # as the reference's TorchTrainer does.
    CudaTrainer(lambda: None, scaling_config=ScalingConfig(
        elastic=ElasticConfig()))
    with pytest.raises(ValueError, match="datasets="):
        TorchTrainer(lambda: None, datasets={"train": [1, 2]})
    with pytest.raises(ValueError, match="async_save"):
        TorchTrainer(lambda: None, run_config=RunConfig(
            checkpoint_config=CheckpointConfig(async_save=True)))
    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        result = TorchTrainer(lambda: None, scaling_config=ScalingConfig(
            use_gpu=False, elastic=ElasticConfig())).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert isinstance(result.error, ValueError)
    assert "thread-tier" in str(result.error)


def test_use_gpu_is_the_default_and_needs_a_card():
    from ray_tpu_torch.train import CudaTrainer, ScalingConfig

    assert ScalingConfig().use_gpu
    assert ScalingConfig(gpus_per_worker=0.5).worker_resources() == {"GPU": 0.5}
    assert ScalingConfig(use_gpu=False).worker_resources() == {"CPU": 1.0}
    fresh_init(ray_tpu_torch, num_cpus=2, num_gpus=0)
    try:
        with pytest.raises(RuntimeError, match="use_gpu=False"):
            CudaTrainer(lambda: None).fit()
    finally:
        ray_tpu_torch.shutdown()


def test_infeasible_bundle_fails_at_once():
    from ray_tpu_torch.train import CudaTrainer, ScalingConfig

    fresh_init(ray_tpu_torch, num_cpus=2)
    try:
        result = CudaTrainer(lambda: None, scaling_config=ScalingConfig(
            num_workers=1, use_gpu=False,
            resources_per_worker={"CPU": 8})).fit()
        assert "fits no node" in str(result.error)
        assert ray_tpu_torch.available_resources()["CPU"] == 2.0
    finally:
        ray_tpu_torch.shutdown()


def test_fit_registers_its_run_and_serves_it_over_http():
    """The run registry follows a fit (world size, attempts, status), and
    the metrics agent's /api/train_runs returns its row."""
    from ray_tpu_torch import train
    from ray_tpu_torch._private.metrics_agent import MetricsAgent
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.train import (
        CudaTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
        run_registry,
    )

    fresh_init(ray_tpu_torch, num_cpus=4)
    failed = {"n": 0}

    def loop():
        if failed["n"] == 0:
            failed["n"] += 1
            raise RuntimeError("once")
        train.report({"ok": 1})

    try:
        run_registry.clear()
        result = CudaTrainer(loop, scaling_config=ScalingConfig(
            num_workers=2, use_gpu=False), run_config=RunConfig(
                name="reg-run", failure_config=FailureConfig(
                    max_failures=1))).fit()
        assert result.error is None and len(result.restarts) == 1
        assert result.restarts[0]["resumed_s"] > 0
        agent = MetricsAgent(get_runtime(), port=0)
        try:
            runs = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{agent.port}/api/train_runs", timeout=5))
        finally:
            agent.stop()
        (row,) = [r for r in runs if r["name"] == "reg-run"]
        assert (row["status"], row["world_size"], row["attempts"]) == \
            ("finished", 2, 2)
        assert ray_tpu_torch.available_resources()["CPU"] == 4.0
    finally:
        run_registry.clear()
        ray_tpu_torch.shutdown()


def test_restart_after_injected_worker_failure():
    """The train_worker_run fault point fails a worker at run entry; the
    attempt restarts and the run finishes."""
    from ray_tpu_torch import train
    from ray_tpu_torch._private import fault_injection
    from ray_tpu_torch.train import (
        CudaTrainer,
        FailureConfig,
        RunConfig,
        ScalingConfig,
    )

    assert "train_worker_run" in fault_injection.FAULT_POINTS
    fresh_init(ray_tpu_torch, num_cpus=2, _system_config={
        "testing_rpc_failure": "train_worker_run=1.0:1"})
    try:
        result = CudaTrainer(
            lambda: train.report({"ok": 1}),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
            run_config=RunConfig(failure_config=FailureConfig(
                max_failures=1))).fit()
        assert result.error is None, result.error
        assert len(result.restarts) == 1
        # The injected crash kills the worker's actor: the liveness poll or
        # the run's own error reports it, whichever comes first.
        assert any(w in result.restarts[0]["error"]
                   for w in ("injected failure", "died")), result.restarts
    finally:
        fresh_init(ray_tpu_torch, num_cpus=1, _system_config={
            "testing_rpc_failure": ""})
        ray_tpu_torch.shutdown()
