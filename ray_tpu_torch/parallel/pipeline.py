"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe`` mesh
axis, the port of ``ray_tpu/parallel/pipeline.py``.

The schedule is the reference's: with S stages and M microbatches the loop
runs S+M-1 ticks, and at tick t stage s works on microbatch t-s; each tick
ends with a shift of every stage's output to the next stage over the open
chain (i, i+1) (``lax.ppermute`` there, ``_private/torch_compat.py``'s
shift here), and the last stage's outputs are replicated over ``pipe`` by a
sum (``psum``). Each stage is one process rank holding its contiguous slice
of the stacked layers (the logical axis "layers" is ``pipe``-sharded by
``DEFAULT_RULES``). The other axes of the mesh stay DTensor dimensions
inside a stage: ``stage_fn`` sees DTensors on the mesh without ``pipe``
(the reference's partial-manual ``shard_map`` leaves them to XLA), or plain
tensors on a ``pipe``-only mesh.

What differs from JAX. The reference runs every stage at every tick (SPMD)
and throws away the bubble's results; here a stage skips the ticks whose
results the reference throws away (stage s before tick s and after tick
s+M-1), but still takes part in that tick's shift, so every rank issues the
same shifts in the same order. JAX derives the backward schedule by
transposing the scan; PyTorch's autograd engine would order the stages'
backward shifts by what is ready in each rank's own graph, which differs
between stages. So the schedule is one ``torch.autograd.Function``: its
forward keeps each computed tick's graph, and its backward walks the ticks
in reverse, one inverse shift a tick (``ppermute``'s transpose), then the
tick's vector-Jacobian product. ``psum``'s transpose for an output every
stage consumes alike hands each stage the whole cotangent. The reference's
fp32 carry on the CPU (``carry_fp32``) works around an XLA fault and has no
counterpart.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

import torch

from ray_tpu_torch.optim import tree_leaves, tree_map

PIPE_AXIS = "pipe"


class _Schedule:
    """What the pipeline Function needs besides its tensors: the stage
    function, the chain's group and this rank's stage, the microbatch
    count, and how a local tensor becomes what ``stage_fn`` sees."""

    def __init__(self, stage_fn, group, stage, n_stages, n_microbatches,
                 wrap_x, wrap_params, unwrap_out, train):
        self.stage_fn, self.group = stage_fn, group
        #: Whether a backward will run: the forward then keeps each tick's
        #: graph.
        self.train = train
        self.stage, self.n_stages = stage, n_stages
        self.m = n_microbatches
        self.wrap_x, self.wrap_params = wrap_x, wrap_params
        self.unwrap_out = unwrap_out

    @property
    def ticks(self) -> int:
        return self.m + self.n_stages - 1

    def microbatch(self, tick: int) -> Optional[int]:
        """The microbatch this stage works on at ``tick``, or None for a
        bubble tick it skips."""
        m = tick - self.stage
        return m if 0 <= m < self.m else None

    def shift(self, x, backward: bool = False):
        """The tick's shift over the open chain (its inverse when
        ``backward``); a stage that receives nothing gets zeros."""
        if self.n_stages == 1:
            return x.new_zeros(x.shape)
        from ray_tpu_torch._private.torch_compat import shift_start

        chain = [(i, i + 1) for i in range(self.n_stages - 1)]
        if backward:
            chain = [(d, s) for s, d in chain]
        return shift_start([x], self.group, chain).wait()[0]


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule over local tensors: x_local (B_local, ...)
    and the stage's parameter shards in; the last stage's outputs
    (zeros on the other stages) out."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x_local, *param_locals):
        mbs = x_local.chunk(sched.m, dim=0)
        last = sched.stage == sched.n_stages - 1
        out_buf: List[Any] = [torch.zeros_like(mb) for mb in mbs]
        ticks = {}
        state = torch.zeros_like(mbs[0])
        for t in range(sched.ticks):
            m = sched.microbatch(t)
            out = torch.zeros_like(mbs[0])
            if m is not None:
                inp = (mbs[m] if sched.stage == 0 else state).detach()
                inp.requires_grad_(sched.train and (
                    x_local.requires_grad or sched.stage > 0))
                params = [p.detach().requires_grad_(
                    sched.train and p.requires_grad)
                    for p in param_locals]
                grad = (torch.enable_grad() if sched.train
                        else contextlib.nullcontext())
                with grad:
                    y = sched.unwrap_out(sched.stage_fn(
                        sched.wrap_params(params), sched.wrap_x(inp)))
                if sched.train:
                    ticks[m] = (inp, params, y)
                out = y.detach()
                if last:
                    out_buf[m] = out
            state = sched.shift(out)
        ctx.sched, ctx.ticks = sched, ticks
        ctx.n_params = len(param_locals)
        ctx.mb_like = mbs[0]
        return torch.cat(out_buf, dim=0)

    @staticmethod
    def backward(ctx, g_buf):
        sched, ticks = ctx.sched, ctx.ticks
        last = sched.stage == sched.n_stages - 1
        g_mbs = g_buf.chunk(sched.m, dim=0)
        g_x = [torch.zeros_like(ctx.mb_like) for _ in range(sched.m)]
        g_params: List[Any] = [None] * ctx.n_params
        g_next = torch.zeros_like(ctx.mb_like)
        for t in reversed(range(sched.ticks)):
            # The transpose of tick t's shift: stage s+1 hands the
            # cotangent of the input it took at tick t+1 back to s.
            g_out = sched.shift(g_next, backward=True)
            g_next = torch.zeros_like(ctx.mb_like)
            m = sched.microbatch(t)
            if m is None:
                continue
            inp, params, y = ticks.pop(m)
            if last:
                g_out = g_mbs[m]
            wrt = [inp] * inp.requires_grad + \
                [p for p in params if p.requires_grad]
            grads = list(torch.autograd.grad(y, wrt, g_out.to(y.dtype),
                                             allow_unused=True))
            g_inp = grads.pop(0) if inp.requires_grad else None
            g_inp = torch.zeros_like(inp) if g_inp is None else g_inp
            if sched.stage == 0:
                g_x[m] = g_inp
            else:
                g_next = g_inp
            for i, p in enumerate(params):
                if not p.requires_grad:
                    continue
                g = grads.pop(0)
                if g is not None:
                    g_params[i] = g if g_params[i] is None \
                        else g_params[i] + g
        return (None, torch.cat(g_x, dim=0), *g_params)


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stage_params: Any,
                   x, *, n_microbatches: int, axis_name: str = PIPE_AXIS,
                   mesh=None):
    """Run ``x`` through a pipeline of identical stages over the ``pipe``
    axis (``ray_tpu/parallel/pipeline.py:pipeline_apply``).

    ``stage_fn(local_params, activations) -> activations`` gets the rank's
    leading-axis slice of every leaf of ``stage_params`` ((layers per stage,
    ...)) and must keep the activations' shape. ``stage_params`` leaves have
    a leading stacked-layer axis divisible by the ``pipe`` axis, sharded
    over it (DTensors placed by the logical axis "layers"). ``x`` (B, ...)
    is replicated over ``pipe``; B % n_microbatches == 0 (and each rank's
    rows divide into the microbatches). ``mesh`` defaults to ``x``'s (a
    DTensor) or the ambient one. Returns activations of x's shape,
    replicated over ``pipe``, placed on the other axes as ``x`` is."""
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(f"batch {B} % n_microbatches {n_microbatches} != 0")
    from ray_tpu_torch._private.torch_compat import is_dtensor
    from ray_tpu_torch.parallel.mesh import Mesh, current_mesh, make_mesh

    if mesh is not None:
        resolved = make_mesh(mesh)
    else:
        resolved = Mesh.of(x) if is_dtensor(x) else current_mesh()
    if resolved is None:
        raise ValueError(
            "pipeline_apply needs a mesh: pass mesh= or call it under "
            "ray_tpu_torch.parallel.use_mesh(...)")
    leaves = tree_leaves(stage_params)
    n_stages = resolved.shape.get(axis_name, 1)
    if axis_name in resolved.shape:
        for leaf in leaves:
            if leaf.shape[0] % n_stages:
                raise ValueError(
                    f"stage_params leading dim {leaf.shape[0]} not divisible "
                    f"by pipe axis size {n_stages}")
    if not is_dtensor(x):
        if n_stages > 1:
            raise TypeError(
                "pipeline_apply over process ranks takes DTensors "
                "(parallel.shard_pytree or create_sharded_state)")
        return _run(stage_fn, stage_params, leaves, x, n_microbatches, None,
                    0, 1, None)
    dm = resolved.device_mesh
    piped = axis_name in resolved.dim_names
    group = dm.get_group(axis_name) if piped else None
    stage = dm.get_local_rank(axis_name) if piped else 0
    return _run_dtensor(stage_fn, stage_params, leaves, x, n_microbatches,
                        dm, axis_name, group, stage, n_stages)


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _run(stage_fn, stage_params, leaves, x_local, n_microbatches, group,
         stage, n_stages, wrap):
    """The schedule over plain local tensors (``wrap`` turns one of them, and
    its DTensor placements, into what ``stage_fn`` sees)."""
    if x_local.shape[0] % n_microbatches:
        raise ValueError(
            f"this rank's {x_local.shape[0]} rows do not divide into "
            f"{n_microbatches} microbatches")
    wrap_x, wrap_leaf, unwrap = wrap or (lambda t: t, lambda i, t: t,
                                         lambda t: t)
    locals_ = [p.to_local() if hasattr(p, "to_local") else p for p in leaves]
    train = torch.is_grad_enabled() and (
        x_local.requires_grad or any(p.requires_grad for p in locals_))
    sched = _Schedule(
        stage_fn, group, stage, n_stages, n_microbatches, wrap_x,
        lambda params: _rebuild(stage_params, [wrap_leaf(i, p) for i, p in
                                               enumerate(params)]),
        unwrap, train)
    return _Pipeline.apply(sched, x_local, *locals_)


def _run_dtensor(stage_fn, stage_params, leaves, x, n_microbatches, dm,
                 axis_name, group, stage, n_stages):
    """DTensors on the mesh: the schedule over their local tensors, each
    stage's inputs rebuilt as DTensors on the mesh without ``pipe``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = list(dm.mesh_dim_names)
    if axis_name in names:
        p = names.index(axis_name)
        if x.placements[p] != Replicate():
            raise ValueError(f"x must be replicated over {axis_name!r}, got "
                             f"{x.placements}")
        rest = [n for n in names if n != axis_name]
        sub = dm[tuple(rest)] if rest else None
    else:
        p, sub = None, dm

    def drop(placements):
        return [q for i, q in enumerate(placements) if i != p]

    # The microbatches' cotangent lives on stage 0 alone: a sum over pipe.
    grad_x = [Partial() if i == p else q for i, q in enumerate(x.placements)]
    x_local = x.to_local(grad_placements=grad_x)
    x_sub = drop(x.placements)
    if p is not None:
        # The reference's in_specs P(pipe): each stage its leading slice.
        leaves = [leaf if leaf.placements[p] == Shard(0) else
                  leaf.redistribute(dm, [Shard(0) if i == p else q for i, q
                                         in enumerate(leaf.placements)])
                  for leaf in leaves]
    leaf_sub = [drop(leaf.placements) for leaf in leaves]

    def wrap_x(t):
        return t if sub is None else DTensor.from_local(t, sub, x_sub)

    def wrap_leaf(i, t):
        return t if sub is None else DTensor.from_local(t, sub, leaf_sub[i])

    def unwrap(y):
        if sub is None or not isinstance(y, DTensor):
            return y
        return y.redistribute(sub, x_sub).to_local()

    out_local = _run(stage_fn, stage_params, leaves, x_local,
                     n_microbatches, group, stage, n_stages,
                     (wrap_x, wrap_leaf, unwrap))
    if p is not None and n_stages > 1:
        from ray_tpu_torch._private.torch_compat import psum

        out_local = psum(out_local, axis_name,
                         mesh=_mesh_of(dm))
    return DTensor.from_local(out_local, dm, x.placements, shape=x.shape,
                              stride=x.stride())


def _mesh_of(dm):
    from ray_tpu_torch.parallel.mesh import Mesh, MeshSpec

    return Mesh(MeshSpec(**dict(zip(dm.mesh_dim_names, dm.shape))), dm)
