"""The port's counterparts of ``ray_tpu/_private/jax_compat.py``: the compile
tap (``InstrumentedJit`` and ``instrumented_jit``) and the mesh helpers
(``shard_map``, ``reshard``, ``device_put_batch``; the last section says
what each is).

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
