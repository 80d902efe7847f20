"""The port's counterparts of ``ray_tpu/_private/jax_compat.py``: the compile
tap (``InstrumentedJit`` and ``instrumented_jit``) and the mesh helpers
(``shard_map``, ``reshard``, ``device_put_batch``; the mesh section says
what each is), and the named-axis collectives of ``jax.lax`` that the
context-parallel attention and the pipeline run over one axis of a mesh of
process ranks (``ppermute``, ``all_to_all``, ``psum``; the last section).

The reference times each trace/lower/compile of a jitted step and records
it into the device-telemetry plane with a classified trigger. The port runs
eagerly and has no such compile; what takes its place is a step function's
first call at a new abstract signature: the call that builds the kernels it
reaches, picks cuBLAS algorithms and grows the caching allocator.
:func:`instrumented_step` wraps a step function, keys its calls by the
reference's signature rules, and times and records each first call
(waiting for the devices it ran on); later calls at a seen signature go
straight through.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple



class InstrumentedStep:
    """A step function with a compile tap: the first call at each abstract
    signature is timed (to the end of its device work) and recorded into
    :mod:`ray_tpu_torch.util.device_telemetry` with a classified trigger
    (first_compile / shape_change / sharding_change). Positional arguments
    only, as the repo calls its steps."""

    def __init__(self, fn: Callable, *, label: Optional[str] = None):
        self._fn = fn
        self.label = label or getattr(fn, "__name__", "step_fn")
        #: the signatures seen, as (shapes, devices) pairs
        self._cache: List[Tuple[Any, Any]] = []

    @staticmethod
    def _signature(args) -> Tuple[Any, Any]:
        """(shapes, devices) of the positional args: tensor and array
        leaves by shape and dtype (plus the pytree structure), Python
        scalars by type (a changed value is not a changed signature), and
        each tensor's device where the reference keys the sharding."""
        import torch
        from torch.utils import _pytree

        leaves, spec = _pytree.tree_flatten(args)
        shapes, devices = [], []
        for leaf in leaves:
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                shapes.append(type(leaf).__name__)
                devices.append(None)
            else:
                shapes.append((tuple(shape), dtype))
                devices.append(leaf.device if isinstance(leaf, torch.Tensor)
                               else None)
        return (tuple(shapes), spec), tuple(devices)

    def __call__(self, *args):
        key = self._signature(args)
        if key in self._cache:
            return self._fn(*args)
        t0 = time.perf_counter()
        out = self._fn(*args)
        _synchronize(key[1])
        seconds = time.perf_counter() - t0
        self._cache.append(key)
        from ray_tpu_torch.util import device_telemetry

        device_telemetry.record_compile(self.label, shapes=key[0],
                                        shardings=key[1], compile_s=seconds)
        return out


def _synchronize(devices) -> None:
    """Wait for the CUDA devices among ``devices``."""
    import torch

    for dev in {d for d in devices if d is not None and d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def instrumented_step(fn: Callable, *, label: Optional[str] = None
                      ) -> InstrumentedStep:
    """Wrap ``fn`` so that each first call at a new abstract signature is
    recorded into the device-telemetry plane (see :class:`InstrumentedStep`)."""
    return InstrumentedStep(fn, label=label)


# ---------------------------------------------------------------- the mesh
# The mesh helpers of ``ray_tpu/_private/jax_compat.py``: ``shard_map`` is
# DTensor's ``local_map``, ``reshard`` is ``distribute_tensor``, and
# ``device_put_batch`` places each numeric column of a host batch as a
# DTensor by a NamedSharding. ``set_mesh`` and ``get_abstract_mesh`` are
# ``parallel.mesh.use_mesh`` and ``current_mesh``; the mesh's axis sizes
# are ``Mesh.shape``.


@dataclass(frozen=True)
class Pending:
    """An output spec whose per-rank values are terms of a sum over
    ``axes``: the psum that a shard_map body would end with, left to
    DTensor as a ``Partial`` placement (a loss summed over batch shards)."""

    spec: Any
    axes: Tuple[str, ...]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor when no mesh
    was ever built: ``torch.distributed.tensor`` is then not loaded)."""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _placements(spec, mesh, pending: Tuple[str, ...] = ()):
    from torch.distributed.tensor import Partial

    from ray_tpu_torch.parallel.mesh import spec_to_placements

    out = spec_to_placements(spec, mesh)
    for name in pending:
        if name in mesh.dim_names:
            out[mesh.dim_names.index(name)] = Partial()
    return out


def shard_map(f: Callable, *, mesh, in_specs, out_specs) -> Callable:
    """``f`` over the rank's local tensors of DTensor arguments on ``mesh``
    (``torch.distributed.tensor.experimental.local_map``): each argument is
    redistributed to its PartitionSpec in ``in_specs`` (None for an
    argument that is no tensor) and ``f`` sees its local shard, so no
    DTensor reaches a kernel. ``out_specs`` is one spec (or a
    ``Pending``) or a list of them, one per output. The gradient of an
    argument that is replicated on a mesh dimension over which another
    argument is sharded is a ``Partial`` sum there (each rank's term, from
    its shard of the other); elsewhere it is placed as the argument is."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def place(spec):
        if isinstance(spec, Pending):
            return _placements(spec.spec, mesh, spec.axes)
        return _placements(spec, mesh)

    ins = tuple(None if s is None else place(s) for s in in_specs)
    outs = (tuple(place(s) for s in out_specs)
            if isinstance(out_specs, list) else place(out_specs))
    sharded = [any(isinstance(p[d], Shard) for p in ins if p is not None)
               for d in range(len(mesh.dim_names))]
    grads = tuple(
        None if p is None else [
            Partial() if isinstance(pd, Replicate) and sharded[d] else pd
            for d, pd in enumerate(p)]
        for p in ins)
    return local_map(f, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh.device_mesh,
                     redistribute_inputs=True)


def reshard(x, mesh, spec):
    """A host array -> a DTensor on ``mesh`` sharded by ``spec`` (every rank
    passes the same array and keeps its shard)."""
    import numpy as np

    from ray_tpu_torch.parallel.mesh import distribute, spec_to_placements

    return distribute(np.asarray(x), mesh, spec_to_placements(spec, mesh))


def device_put_batch(batch: Dict[str, Any], sharding, *,
                     transfer_src: str = "device_put_batch"
                     ) -> Dict[str, Any]:
    """A dict-of-columns host batch placed by the ``NamedSharding``
    ``sharding``: numeric columns become DTensors on its mesh (the spec
    truncated to each column's rank, so 1-D labels ride beside 2-D tokens);
    other columns stay on the host untouched. The bytes are ledgered as an
    h2d transfer when the device-telemetry plane is loaded."""
    import sys

    import numpy as np
    import torch

    from ray_tpu_torch.parallel.mesh import distribute

    out: Dict[str, Any] = {}
    nbytes = 0
    for key, col in batch.items():
        arr = col if hasattr(col, "dtype") else np.asarray(col)
        if not hasattr(arr, "dtype") or getattr(arr.dtype, "kind",
                                                "f") not in "biufc":
            out[key] = col
            continue
        t = torch.as_tensor(np.asarray(arr)) if not isinstance(
            arr, torch.Tensor) else arr
        fit = sharding.fit(t.ndim)
        out[key] = distribute(t, fit.mesh, fit.placements)
        nbytes += t.numel() * t.element_size()
    telemetry = sys.modules.get("ray_tpu_torch.util.device_telemetry")
    if telemetry is not None and nbytes:
        telemetry.record_transfer("h2d", nbytes, src=transfer_src)
    return out


# ------------------------------------------------ named-axis collectives
# ``lax.ppermute``, ``lax.all_to_all`` and ``lax.psum`` over one named axis
# of a mesh of process ranks: the axis's process group is
# ``DeviceMesh.get_group(axis)`` and a rank's index on it its coordinate.
# Each is a ``torch.autograd.Function`` whose backward is JAX's transpose.
# Over gloo a CUDA tensor is staged through host memory (a gloo ``send`` of
# a CUDA tensor kills the sender, scripts/torch_gloo_cuda_probe.py); NCCL
# moves the CUDA tensor itself. Collectives pair by order: every rank of
# the axis issues the same ones in the same order, from the forward and
# backward of these Functions (whose order a graph the ranks share fixes),
# never from hooks.


def _axis_mesh(mesh):
    from ray_tpu_torch.parallel.mesh import current_mesh, make_mesh

    resolved = current_mesh() if mesh is None else make_mesh(mesh)
    if resolved is None or resolved.device_mesh is None:
        raise ValueError("a named-axis collective needs a mesh over process "
                         "ranks: pass mesh= or install one with use_mesh")
    return resolved


def axis_group(mesh, axis: str):
    """The process group of ``axis`` on ``mesh`` (a ``Mesh`` over process
    ranks): the ranks that differ from this one on ``axis`` alone."""
    mesh = _axis_mesh(mesh)
    if axis not in mesh.dim_names:
        raise ValueError(f"mesh dimensions {mesh.dim_names} have no "
                         f"{axis!r}")
    return mesh.device_mesh.get_group(axis)


def _gloo(group) -> bool:
    import torch.distributed as dist

    return "nccl" not in str(dist.get_backend(group))


def _staged(x, group) -> bool:
    """Whether ``x`` goes through host memory on ``group``: a CUDA tensor
    on any backend but NCCL."""
    return x.is_cuda and _gloo(group)


class Shift:
    """A point-to-point shift in flight: ``wait()`` gives what this rank
    received, on the device of what it sent (zeros where nothing came)."""

    def __init__(self, works, sent, received, device):
        # The sent tensors are held until the sends are done.
        self._works, self._sent = works, sent
        self._received, self._device = received, device

    def wait(self):
        for work in self._works:
            work.wait()
        self._sent = None
        return [r.to(self._device) for r in self._received]


def shift_start(tensors, group, perm) -> Shift:
    """Posts ``lax.ppermute(x, axis, perm)`` of each of ``tensors`` on the
    axis's ``group`` and returns at once: each (src, dst) of ``perm`` (axis
    indices) moves src's tensor to dst, all in one batch of isend/irecv.
    Over gloo a CUDA tensor is copied to the host first (which waits for
    the work queued before it on its stream) and back at ``wait``."""
    import torch
    import torch.distributed as dist

    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    device = tensors[0].device
    staged = _staged(tensors[0], group)
    sent, received, ops = [], [], []
    for x in tensors:
        x = x.detach().contiguous()
        x = x.cpu() if staged else x
        sent.append(x)
        out = torch.zeros_like(x)
        received.append(out)
        # Gloo moves the bytes (its point-to-point takes any type so).
        wire, into = (x, out) if not _gloo(group) else (
            x.view(torch.uint8), out.view(torch.uint8))
        ops += [dist.P2POp(dist.isend, wire, ranks[d], group) for d in dsts]
        ops += [dist.P2POp(dist.irecv, into, ranks[s], group) for s in srcs]
    works = dist.batch_isend_irecv(ops) if ops else []
    return Shift(works, sent, received, device)


def _inverse(perm):
    return [(d, s) for s, d in perm]


def _ppermute_function():
    import torch

    class PPermute(torch.autograd.Function):
        """``lax.ppermute``; its transpose is the inverse permutation."""

        @staticmethod
        def forward(ctx, x, group, perm):
            ctx.group, ctx.perm = group, perm
            return shift_start([x], group, perm).wait()[0]

        @staticmethod
        def backward(ctx, g):
            return (shift_start([g], ctx.group, _inverse(ctx.perm))
                    .wait()[0], None, None)

    return PPermute


def ppermute(x, axis: str, perm, *, mesh=None):
    """``lax.ppermute(x, axis, perm)`` over ``axis`` of ``mesh`` (the
    ambient mesh by default): each (src, dst) of ``perm`` moves src's ``x``
    to dst; a rank that receives nothing gets zeros, as on an open chain.
    The gradient travels the inverse permutation."""
    return _function("ppermute", _ppermute_function).apply(
        x, axis_group(mesh, axis), [tuple(p) for p in perm])


_functions = {}


def _function(name, make):
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = make()
    return fn


def _all_to_all(x, group, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`` on
    the axis's ``group``: ``x`` cut into W pieces along ``split_axis``,
    piece j sent to rank j, the W pieces received laid side by side along
    ``concat_axis`` in rank order. Gloo takes CUDA tensors in
    ``all_to_all_single``, so nothing is staged."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size(group)
    if x.shape[split_axis] % world:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} is not divisible by {world}")
    send = x.unflatten(split_axis, (world, x.shape[split_axis] // world)) \
        .movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] is rank j's piece; rank order is major along concat_axis.
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def _all_to_all_function():
    import torch

    class AllToAll(torch.autograd.Function):
        """``lax.all_to_all``; its transpose swaps the two axes."""

        @staticmethod
        def forward(ctx, x, group, split_axis, concat_axis):
            ctx.args = (group, concat_axis, split_axis)
            return _all_to_all(x, group, split_axis, concat_axis)

        @staticmethod
        def backward(ctx, g):
            return _all_to_all(g, *ctx.args), None, None, None

    return AllToAll


def all_to_all(x, axis: str, split_axis: int, concat_axis: int, *,
               mesh=None):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`` over
    ``axis`` of ``mesh`` (the ambient mesh by default), differentiable."""
    return _function("all_to_all", _all_to_all_function).apply(
        x, axis_group(mesh, axis), split_axis, concat_axis)


def _psum_function():
    import torch

    class PSum(torch.autograd.Function):
        """``lax.psum`` whose result is replicated over the axis (a
        shard_map output of spec ``P()``): every rank then computes the
        same thing from it, so each rank's cotangent is the whole one and
        the transpose hands it on unchanged."""

        @staticmethod
        def forward(ctx, x, group):
            import torch.distributed as dist

            import torch

            out = x.detach().clone()
            if _gloo(group):  # through host memory, 16-bit types in fp32
                out = out.cpu()
                if out.dtype in (torch.bfloat16, torch.float16):
                    out = out.float()
            dist.all_reduce(out, group=group)
            return out.to(x.device, x.dtype)

        @staticmethod
        def backward(ctx, g):
            return g, None

    return PSum


def psum(x, axis: str, *, mesh=None):
    """``lax.psum(x, axis)`` over ``axis`` of ``mesh`` (the ambient mesh by
    default), replicated over the axis; see ``PSum`` for its gradient."""
    return _function("psum", _psum_function).apply(x,
                                                    axis_group(mesh, axis))
