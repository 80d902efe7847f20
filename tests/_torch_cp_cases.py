"""What the ranks of a ``_torch_mesh`` world run for the context-parallel and
pipeline tests (``tests/test_torch_long_context.py``,
``tests/test_torch_pipeline.py``): the port's ring, Ulysses and GPipe over
gloo processes on the CPU. Each function runs in every rank, builds its
mesh from a ``MeshSpec`` given as keyword arguments and returns numpy
values (DTensors gathered with ``full_tensor()``) or plain Python; it
imports torch and the port, never JAX. A refusal a rank meets comes back
as its message, so the world lives on for the next case.
"""

import numpy as np
import torch

from ray_tpu_torch.models import convert, gpt2, llama
from ray_tpu_torch.ops import ring_attention as ra
from ray_tpu_torch.parallel import (MeshSpec, logical_to_placements,
                                    make_mesh, pipeline_apply, shard_pytree)
from ray_tpu_torch.parallel.mesh import (PartitionSpec, distribute,
                                         spec_to_placements)

#: How the reference's tests place (B, S, ...) arrays on a mesh.
BATCH_SEQ = PartitionSpec(("data", "fsdp"), "seq")


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().numpy()


def _place(mesh, arrays, spec=BATCH_SEQ):
    return [distribute(torch.as_tensor(a), mesh,
                       spec_to_placements(spec, mesh)) for a in arrays]


def context_parallel(spec, kind, arrays, causal=True, impl="auto",
                     grads=False):
    """``ring_attention`` or ``ulysses_attention`` (``kind``) of q, k, v
    placed over (batch, seq) on the mesh: the output and, with ``grads``,
    the gradients of sum(out ** 2), gathered; and the ring kernels'
    launches (none on the CPU)."""
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    q, k, v = (t.requires_grad_(grads) for t in _place(mesh, arrays))
    ra.reset_launches()
    try:
        if kind == "ring":
            out = ra.ring_attention(q, k, v, mesh=mesh, causal=causal,
                                    impl=impl)
        else:
            out = ra.ulysses_attention(q, k, v, mesh=mesh, causal=causal)
    except ValueError as e:
        return {"error": str(e)}
    res = {"out": _np(out), "local": tuple(out.to_local().shape)}
    if grads:
        loss = (out.float() ** 2).sum().full_tensor()
        res["grads"] = [_np(g) for g in torch.autograd.grad(loss, (q, k, v))]
    res["launches"] = dict(ra.LAUNCHES)
    return res


def process_ring_steps(spec, arrays, causal):
    """The per-rank ring's forward and backward on this rank's shard
    (``ring_forward_shard`` and ``ring_backward_shard`` with the plain
    blocks), against the folded ring's plain steps over the whole sequence
    on this rank: the rank's rows of o, lse and its chunk's dq, dk, dv,
    each as the largest difference."""
    import torch.distributed as dist

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    group = mesh.device_mesh.get_group("seq")
    W, i = dist.get_world_size(group), dist.get_rank(group)
    q, k, v, do = (torch.as_tensor(a) for a in arrays)
    S = q.shape[1] // W
    rows = slice(i * S, (i + 1) * S)
    mine = [t[:, rows].contiguous() for t in (q, k, v, do)]
    o, lse = ra.ring_forward_shard(*mine[:3], group=group, causal=causal)
    grads = ra.ring_backward_shard(*mine[:3], o, lse, mine[3], group=group,
                                   causal=causal)
    o_f, lse_f = ra.ring_forward(q, k, v, world=W, causal=causal, plain=True)
    want = ra.ring_backward(q, k, v, o_f, lse_f, do, world=W, causal=causal,
                            plain=True)
    diff = [float((o - o_f[:, rows]).abs().max()),
            float((lse - lse_f[:, :, rows]).abs().max())]
    diff += [float((g - w[:, rows]).abs().max())
             for g, w in zip(grads, want)]
    return diff


def embed_positions(spec, np_params, tokens):
    """GPT-2's token and position embedding of (batch, seq)-placed tokens,
    gathered: each seq shard must add the table rows of its own global
    positions."""
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    params = convert.params_from_numpy(np_params, device="cpu")
    (t,) = _place(mesh, [tokens])
    return _np(gpt2._embed(params["wte"], params["wpe"], t, torch.float32))


def llama_forward(spec, cfg_kw, np_params, tokens):
    """Llama's logits with tokens placed over (batch, seq), gathered."""
    config = llama.LlamaConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    params = shard_pytree(convert.params_from_numpy(np_params, device="cpu"),
                          llama.logical_axes(config), mesh)
    (t,) = _place(mesh, [tokens])
    with torch.no_grad():
        return _np(llama.forward(params, t, config))


def batch_blocks(spec, tokens):
    """``local_batch_to_global`` of this rank's (B/data, S/seq) block of
    ``tokens``: the global shape, placements and gathered values."""
    from ray_tpu_torch.collective import distributed
    from ray_tpu_torch.parallel import batch_sharding
    from ray_tpu_torch.parallel.mesh import axis_index

    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    t = np.asarray(tokens)
    b = t.shape[0] // mesh.shape["data"]
    s = t.shape[1] // mesh.shape["seq"]
    d, j = axis_index(mesh, "data"), axis_index(mesh, "seq")
    block = t[d * b:(d + 1) * b, j * s:(j + 1) * s]
    g = distributed.local_batch_to_global(mesh, block,
                                          axis=batch_sharding(mesh).spec)
    return {"shape": tuple(g.shape), "full": _np(g),
            "placements": [repr(p) for p in g.placements]}


def _tanh_stack(local_w, h):
    for i in range(local_w.shape[0]):
        h = torch.tanh(h @ local_w[i])
    return h


def pipeline(spec, w, x, n_microbatches, grads=False):
    """``pipeline_apply`` of a tanh layer stack (``tests/test_pipeline.py``'s
    stage function), the layers placed over ``pipe`` and the rows over
    ``data``: the output and, with ``grads``, the gradient of sum(out ** 2)
    with respect to the layers, gathered, and each rank's local layer
    count."""
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    wd = distribute(torch.as_tensor(w), mesh,
                    logical_to_placements(("layers", None, None), mesh))
    (xd,) = _place(mesh, [x])
    wd.requires_grad_(grads)
    out = pipeline_apply(_tanh_stack, wd, xd, n_microbatches=n_microbatches)
    res = {"out": _np(out), "local_layers": wd.to_local().shape[0],
           "placements": [repr(p) for p in out.placements]}
    if grads:
        loss = (out ** 2).sum().full_tensor()
        (g,) = torch.autograd.grad(loss, [wd])
        res["grad"] = _np(g)
    return res


def gpt2_forward(spec, cfg_kw, np_params, tokens):
    """GPT-2's logits on the mesh (pipelined when the config says so)."""
    config = gpt2.GPTConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(**spec), device="cpu")
    params = shard_pytree(convert.params_from_numpy(np_params, device="cpu"),
                          gpt2.logical_axes(config), mesh)
    (t,) = _place(mesh, [tokens])
    with torch.no_grad():
        return _np(gpt2.forward(params, t, config))


def gpt2_refusal(spec, cfg_kw, np_params, tokens):
    """What GPT-2's forward raises on the mesh, as its message (None when
    it raises nothing)."""
    try:
        gpt2_forward(spec, cfg_kw, np_params, tokens)
    except ValueError as e:
        return str(e)
    return None
