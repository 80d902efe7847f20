"""What the ranks of a ``_torch_mesh`` world run: the port on a device mesh
of gloo processes on the CPU. Every function here runs in each rank, builds
its mesh from a ``MeshSpec`` given as keyword arguments, and returns numpy
values (full tensors gathered with ``full_tensor()``) or plain Python; it
imports torch and the port, never JAX.
"""

from functools import partial

import numpy as np
import torch

from ray_tpu_torch.models import convert, gpt2, llama, moe, vit
from ray_tpu_torch.optim import AdamW, tree_leaves
from ray_tpu_torch.parallel import (MeshSpec, batch_sharding,
                                    create_sharded_state,
                                    logical_to_placements, make_mesh,
                                    shard_pytree)
from ray_tpu_torch.parallel.mesh import distribute

MODELS = {"gpt2": (gpt2, gpt2.GPTConfig), "llama": (llama, llama.LlamaConfig),
          "vit": (vit, vit.ViTConfig), "moe": (moe, moe.MoEConfig)}


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().numpy()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _placed(tree):
    """Each leaf's local shape and placements, in leaf order."""
    return [(tuple(p.to_local().shape), [repr(x) for x in p.placements])
            for p in tree_leaves(tree)]


def _batch(mesh, *arrays):
    sh = batch_sharding(mesh)
    return [distribute(torch.as_tensor(a), mesh, sh.fit(a.ndim).placements)
            for a in arrays]


def model_step(name, spec, cfg_kw, np_params, inputs, targets, ref_grads=None,
               opt_kw=None):
    """One step of ``name`` on the mesh from the reference's weights: the
    loss, every gradient (gathered), rank 0's own gradients before their
    redistribution, each rank's local shapes and placements, and, given
    the reference's gradients, the parameters after one AdamW update from
    them (the optimizer on DTensors, with the reference's numbers in)."""
    mod, Config = MODELS[name]
    config = Config(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    params = shard_pytree(convert.params_from_numpy(np_params, device="cpu"),
                          mod.logical_axes(config), mesh)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    x, y = _batch(mesh, inputs, targets)
    loss = mod.loss_fn(params, x, y, config)
    raw = torch.autograd.grad(loss, leaves)
    own = [g.to_local().detach().float().numpy() for g in raw]
    from ray_tpu_torch.optim import _as_placed

    grads = [_np(g) for g in _as_placed(raw, leaves)]
    out = {"loss": float(loss.detach().full_tensor()), "grads": grads,
           "own": own,
           "placed": _placed(params)}
    if ref_grads is not None:
        opt = AdamW(**(opt_kw or {}))
        for p in leaves:
            p.requires_grad_(False)
        g_tree = shard_pytree(
            convert.params_from_numpy(ref_grads, device="cpu"),
            mod.logical_axes(config), mesh)
        state = opt.init(params)
        opt.update(g_tree, state, params)
        out["updated"] = [_np(p) for p in leaves]
        out["mu_placed"] = _placed(state["mu"])
    return out if _rank() == 0 else out["placed"]


def train_losses(name, spec, cfg_kw, np_params, inputs, targets, steps,
                 opt_kw):
    """``steps`` train steps (``make_train_step``) on the mesh: the losses,
    and whether every rank ends with the same parameters."""
    mod, Config = MODELS[name]
    config = Config(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    params = shard_pytree(convert.params_from_numpy(np_params, device="cpu"),
                          mod.logical_axes(config), mesh)
    opt = AdamW(**opt_kw)
    state = opt.init(params)
    step = mod.make_train_step(config, opt)
    x, y = _batch(mesh, inputs, targets)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))
    return losses, [_np(p) for p in tree_leaves(params)]


def sharded_state(name, spec, cfg_kw, seed):
    """``create_sharded_state`` against the single-process ``init_params``:
    per leaf, whether the rank's shard is bit for bit the slice of the full
    draw it should hold, its placements, and the moments' types and
    placements."""
    mod, Config = MODELS[name]
    config = Config(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    opt = AdamW()
    params, state = create_sharded_state(
        partial(mod.init_params, config), mod.logical_axes(config), mesh,
        seed, opt)
    full = mod.init_params(config, seed, device="cpu")
    logical = mod.logical_axes(config)
    same, placed = [], []
    for p, f, axes in zip(tree_leaves(params), tree_leaves(full),
                          _logical_leaves(logical)):
        want = distribute(f, mesh, logical_to_placements(axes, mesh))
        same.append(bool(torch.equal(p.to_local(), want.to_local())))
        placed.append(p.placements == want.placements)
    mu = [(str(m.dtype), m.placements == p.placements)
          for m, p in zip(tree_leaves(state["mu"]), tree_leaves(params))]
    return {"same": same, "placed": placed, "mu": mu}


def _logical_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _logical_leaves(v)]
    return [tree]


def moe_forward(spec, cfg_kw, np_params, tokens):
    """MoE logits and aux loss on the mesh (experts sharded over
    ``expert``) and on this rank alone with the same weights."""
    config = moe.MoEConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    plain = convert.params_from_numpy(np_params, device="cpu")
    params = shard_pytree(plain, moe.logical_axes(config), mesh)
    (x,) = _batch(mesh, tokens)
    with torch.no_grad():
        logits, aux = moe.forward(params, x, config)
        want, want_aux = moe.forward(plain, torch.as_tensor(tokens), config)
    placed = [repr(p) for p in params["blocks"]["expert_in_w"].placements]
    return {"logits": _np(logits), "aux": float(_np(aux)),
            "want": want.numpy(), "want_aux": float(want_aux),
            "expert_in_w": placed,
            "local": tuple(params["blocks"]["expert_in_w"].to_local().shape)}


def local_batch_to_global(spec, rows, cols, axis="data"):
    """Each rank's own rows -> one global batch over ``axis``."""
    from ray_tpu_torch.collective import distributed

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    local = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols) \
        + 1000 * _rank()
    g = distributed.local_batch_to_global(mesh, local, axis=axis)
    return {"shape": tuple(g.shape), "full": _np(g),
            "placements": [repr(p) for p in g.placements]}


def collectives_on_mesh(spec):
    """Each redistribution of a DTensor on the mesh and the collective it
    rides: all-reduce (Partial -> Replicate), reduce-scatter (Partial ->
    Shard), all-gather (Shard -> Replicate), and a scatter from rank 0
    (``distribute_tensor`` with its source rank)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    dm = mesh.device_mesh
    n = dm.size()
    r = _rank()
    mine = torch.arange(2 * n, dtype=torch.float32) * (r + 1)
    part = DTensor.from_local(mine, dm, [Partial()] * dm.ndim)
    out = {
        "all_reduce": part.redistribute(dm, [Replicate()] * dm.ndim)
        .to_local().numpy(),
        "reduce_scatter": part.redistribute(dm, [Shard(0)] * dm.ndim)
        .to_local().numpy(),
    }
    shard = DTensor.from_local(torch.full((2,), float(r)), dm,
                               [Shard(0)] * dm.ndim)
    out["all_gather"] = shard.full_tensor().numpy()
    src = torch.full((2 * n,), float(r))
    out["scatter"] = distribute_tensor(src, dm, [Shard(0)] * dm.ndim,
                                       src_data_rank=0).to_local().numpy()
    return out


def restore_onto_mesh(root, spec):
    """``restore_latest(root, mesh=)``: each leaf's placements, local shape
    and gathered values."""
    from ray_tpu_torch.checkpoint import restore_latest

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    tree = restore_latest(root, mesh=mesh)
    return {k: ([repr(p) for p in v.placements], tuple(v.to_local().shape),
                _np(v)) for k, v in tree.items()}


def device_iterator(spec):
    """``DeviceBatchIterator(sharding=batch_sharding(mesh))`` over three
    batches, and a batch of 2-D tokens beside 1-D labels."""
    from ray_tpu_torch.data.ingest.prefetch import DeviceBatchIterator

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    sharding = batch_sharding(mesh)
    src = ({"x": np.ones((8, 4), dtype=np.float32) * i} for i in range(3))
    out = list(DeviceBatchIterator(src, sharding=sharding))
    mixed = [{"tokens": np.ones((8, 4), dtype=np.int32),
              "label": np.arange(8, dtype=np.int64), "name": ["a"] * 8}]
    (m,) = list(DeviceBatchIterator(mixed, sharding=sharding))
    return {"n": len(out),
            "placed": out[1]["x"].placements == tuple(sharding.placements),
            "values": [_np(b["x"]).tolist() for b in out],
            "tokens": m["tokens"].placements == tuple(sharding.placements),
            "label": (tuple(m["label"].shape), _np(m["label"]).tolist()),
            "name": m["name"]}



def kernels_refuse_dtensors(spec):
    """What the splash and fused-CE wrappers raise when handed DTensors,
    and that ``shard_map`` hands them the local tensors instead."""
    from ray_tpu_torch.ops.attention import splash_attention
    from ray_tpu_torch.ops.fused_ce import fused_lm_head_ce

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    q = distribute(torch.zeros(4, 8, 2, 16), mesh,
                   batch_sharding(mesh).fit(4).placements)
    x = distribute(torch.zeros(4, 8, 64), mesh,
                   batch_sharding(mesh).fit(3).placements)
    t = distribute(torch.zeros(4, 8, dtype=torch.long), mesh,
                   batch_sharding(mesh).placements)
    out = []
    for call in (lambda: splash_attention(q, q, q),
                 lambda: fused_lm_head_ce(x, torch.zeros(96, 64), t)):
        try:
            call()
            out.append(None)
        except TypeError as e:
            out.append(str(e))
    cfg = gpt2.GPTConfig(vocab_size=96, n_layer=1, n_head=2, d_model=32,
                         seq_len=8, dtype=torch.float32, attn_impl="splash")
    local = gpt2._attention(q, q, q, cfg)
    out.append((tuple(local.shape), repr(local.placements[0])))
    return out


def profiled_step(spec, cfg_kw, tokens):
    """One GPT-2 step on the mesh from the same sharded state, plain and
    under an active ``StepProfiler``: the profiled step's bucket row and
    whether both steps left the same loss and parameters (the profiler's
    waits before the gradient sync change no number)."""
    from ray_tpu_torch.collective import distributed
    from ray_tpu_torch.train import profiler

    config = gpt2.GPTConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    t = torch.as_tensor(np.asarray(tokens))
    i, shards = 0, 1
    for name in ("data", "fsdp"):  # the batch shard, major to minor
        if name in mesh.dim_names:
            i = i * mesh.shape[name] + mesh.device_mesh.get_local_rank(name)
            shards *= mesh.shape[name]
    b = t.shape[0] // shards
    mine = t[i * b:(i + 1) * b]
    x, y = (distributed.local_batch_to_global(mesh, u.contiguous(),
                                              axis=("data", "fsdp"))
            for u in (mine[:, :-1], mine[:, 1:]))
    opt = gpt2.make_optimizer(1e-3)
    out = []
    for timed in (False, True):
        params, state = create_sharded_state(
            partial(gpt2.init_params, config), gpt2.logical_axes(config),
            mesh, 0, opt)
        prof = profiler.StepProfiler(run_name="mesh-test", rank=_rank())
        profiler.activate(prof if timed else None)
        try:
            params, state, loss = gpt2.make_train_step(config, opt)(
                params, state, x, y)
            row = prof.step_boundary()
        finally:
            profiler.activate(None)
        out.append((float(loss), [p.to_local().clone()
                                   for p in tree_leaves(params)], row))
    (loss0, p0, _), (loss1, p1, row) = out
    return {"row": row, "same": loss0 == loss1 and all(
        torch.equal(a, b) for a, b in zip(p0, p1))}
