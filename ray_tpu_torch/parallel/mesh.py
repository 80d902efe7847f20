"""Named parallelism axes, logical sharding rules and the ambient mesh: the
port of ``ray_tpu/parallel/mesh.py``.

``AXIS_NAMES``, ``MeshSpec``, ``DEFAULT_RULES`` and ``logical_to_spec`` are
the JAX package's, copied (the port imports nothing of ``ray_tpu``). What
differs is what a mesh is. In JAX it is a grid of devices that XLA's SPMD
partitioner splits arrays over. Here it is one of two things:

- a mesh spans the ranks of the joined ``torch.distributed`` process group,
  one rank per mesh position, as a ``DeviceMesh`` whose dimensions are the
  axes above 1, in ``AXIS_NAMES`` order (an axis of size 1 shards nothing
  and is no dimension). A tensor on it is a ``DTensor`` with one
  ``Shard(dim)`` or ``Replicate()`` per mesh dimension: the placements that
  ``logical_to_placements`` derives from ``DEFAULT_RULES``, so each rank
  holds the shard that ``logical_to_spec`` names. DTensor's sharding
  propagation then stands where XLA's partitioner stands in the reference.
  The ``seq`` axis holds sequence shards there (the context-parallel
  attention of ``ops/ring_attention.py`` rings them between the ranks) and
  ``pipe`` the stages of ``parallel/pipeline.py``;
- a ``seq``-only mesh (every other axis 1) in a process that joined no
  process group of ``spec.size`` ranks is folded onto the one device of the
  process: the tensors hold all W sequence shards side by side and the
  context-parallel attention runs its W ranks as kernel launches over them.

``use_mesh`` installs a mesh as the ambient one, the counterpart of
``jax.set_mesh`` (``ray_tpu/_private/jax_compat.py:set_mesh``), and
``current_mesh`` reads it. The ambient mesh is process-wide, not
per-thread: autograd runs a CUDA backward, and a checkpointed block's
recompute, on a thread of its own, which must see the mesh of the step that
started it.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

AXIS_NAMES = ("pipe", "data", "fsdp", "expert", "tensor", "seq")


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    @property
    def size(self) -> int:
        return (self.pipe * self.data * self.fsdp * self.expert
                * self.tensor * self.seq)

    def axis_sizes(self) -> Dict[str, int]:
        return {"pipe": self.pipe, "data": self.data, "fsdp": self.fsdp,
                "expert": self.expert, "tensor": self.tensor, "seq": self.seq}

    @staticmethod
    def auto(n_devices: int, tensor: int = 1, seq: int = 1,
             fsdp: Optional[int] = None, pipe: int = 1,
             expert: int = 1) -> "MeshSpec":
        """Fill the data axis with whatever the other axes don't consume."""
        inner = tensor * seq * (fsdp or 1) * pipe * expert
        if n_devices % inner != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by "
                f"pipe*expert*tensor*seq*fsdp={inner}")
        return MeshSpec(data=n_devices // inner, fsdp=fsdp or 1,
                        tensor=tensor, seq=seq, pipe=pipe, expert=expert)


# Logical axis rules: model code annotates params with logical axis names and
# these rules map them to mesh axes (the reference's table, copied).
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "vocab": ("tensor",),
    "embed": ("fsdp",),
    "heads": ("tensor",),
    "kv": None,
    "mlp": ("tensor",),
    "batch": ("data", "fsdp"),
    "seqlen": ("seq",),
    "norm": None,
    # Leading stacked-layer axis of a pipelined block stack.
    "layers": ("pipe",),
    # Leading expert axis of MoE expert weights (models/moe.py).
    "expert": ("expert",),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (not sharded), a mesh axis name,
    or a tuple of names (sharded over their product, major to minor), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def partition(*axes) -> PartitionSpec:
    return PartitionSpec(*axes)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Dict] = None) -> PartitionSpec:
    """('vocab','embed') -> PartitionSpec('tensor', 'fsdp')."""
    rules = rules or DEFAULT_RULES
    spec: List[Any] = []
    for name in logical_axes:
        mapped = None if name is None else rules.get(name)
        if mapped is None:
            spec.append(None)
        elif len(mapped) == 1:
            spec.append(mapped[0])
        else:
            spec.append(tuple(mapped))
    return PartitionSpec(*spec)


@dataclass(frozen=True)
class Mesh:
    """A validated ``MeshSpec``. ``shape`` maps each of the six axis names to
    its size, as a JAX mesh's does. ``device_mesh`` is the ``DeviceMesh``
    over the process group (None for a mesh folded onto one device), with
    ``dim_names`` its dimensions."""

    spec: MeshSpec
    device_mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def axis_names(self):
        return AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.axis_sizes()

    @property
    def size(self) -> int:
        return self.spec.size

    @property
    def dim_names(self) -> Tuple[str, ...]:
        if self.device_mesh is None:
            return ()
        return tuple(self.device_mesh.mesh_dim_names)

    @staticmethod
    def of(x) -> "Mesh":
        """The mesh a DTensor lies on."""
        dm = x.device_mesh
        sizes = dict(zip(dm.mesh_dim_names, dm.shape))
        return Mesh(MeshSpec(**sizes), dm)


MeshLike = Union[Mesh, MeshSpec]


def _validate(spec: MeshSpec) -> None:
    bad = {n: s for n, s in spec.axis_sizes().items() if s < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")


def make_mesh(spec: MeshLike, devices: Optional[Sequence[int]] = None, *,
              device=None) -> Mesh:
    """The mesh of ``spec`` over the joined process group, whose world size
    must equal ``spec.size``: ``devices`` lists its ranks in mesh order
    (default 0..size-1, the reference's device order), and ``device`` is
    the device type of the ranks' tensors (the card unless the caller asks
    for the CPU). A ``seq``-only mesh spans the group when the group has
    ``spec.size`` ranks, and otherwise folds onto this process's device (no
    group, a group of one, or ranks that each run a folded ring of their
    own)."""
    if isinstance(spec, Mesh):
        return spec
    _validate(spec)
    sizes = spec.axis_sizes()
    from ray_tpu_torch.collective import distributed

    world = distributed.process_count()
    seq_only = all(s == 1 for n, s in sizes.items() if n != "seq")
    if seq_only and not (world > 1 and spec.size == world):
        return Mesh(spec)
    if spec.size != world:
        raise ValueError(
            f"MeshSpec needs {spec.size} processes, the process group has "
            f"{world}")
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch._private.device import resolve_device

    names = tuple(n for n in AXIS_NAMES if sizes[n] > 1)
    ranks = np.arange(world) if devices is None else np.asarray(devices)
    if sorted(ranks.tolist()) != list(range(world)):
        raise ValueError(f"devices must be the ranks 0..{world - 1}")
    grid = ranks.reshape([sizes[n] for n in names])
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        # The rank's card before the mesh binds it (ranks on one host may
        # share it; DeviceMesh would otherwise guess rank % cards).
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    return Mesh(spec, DeviceMesh(dev.type, grid.tolist(),
                                 mesh_dim_names=names))


def axis_index(mesh: Mesh, name: str) -> int:
    """This rank's coordinate on the ``name`` axis of ``mesh``: 0 when the
    axis is no dimension of it (size 1, or folded). ``lax.axis_index``."""
    if name not in mesh.dim_names:
        return 0
    return mesh.device_mesh.get_local_rank(name)


def spec_to_placements(spec: Sequence, mesh: Mesh) -> List[Any]:
    """A PartitionSpec -> one ``Shard(dim)`` or ``Replicate()`` per
    dimension of ``mesh.device_mesh``; axes of size 1 are no dimension."""
    from torch.distributed.tensor import Replicate, Shard

    placements: List[Any] = [Replicate()] * len(mesh.dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            if name in mesh.dim_names:
                placements[mesh.dim_names.index(name)] = Shard(dim)
    return placements


def logical_to_placements(logical_axes: Sequence[Optional[str]], mesh: Mesh,
                          rules: Optional[Dict] = None) -> List[Any]:
    """The DTensor placements of ``logical_to_spec(logical_axes, rules)``:
    ('batch', 'seqlen') on a data x fsdp mesh -> [Shard(0), Shard(0)]."""
    return spec_to_placements(logical_to_spec(logical_axes, rules), mesh)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec, as ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> List[Any]:
        return spec_to_placements(self.spec, self.mesh)

    def fit(self, ndim: int) -> "NamedSharding":
        """The spec truncated to ``ndim`` axes, so one batch sharding serves
        every column rank of a dict batch."""
        if len(self.spec) <= ndim:
            return self
        return NamedSharding(self.mesh, PartitionSpec(*self.spec[:ndim]))


def named_sharding(mesh: Mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*axes))


def batch_sharding(mesh: Mesh, rules: Optional[Dict] = None) -> NamedSharding:
    """Sharding for a (batch, seq) token array: batch -> (data, fsdp),
    seq -> seq."""
    return NamedSharding(mesh, logical_to_spec(("batch", "seqlen"), rules))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def _map_logical(fn, tree, logical):
    if isinstance(logical, dict):
        return {k: _map_logical(fn, tree[k], logical[k]) for k in logical}
    if isinstance(logical, list) or (isinstance(logical, tuple)
                                     and not _is_logical(logical)):
        return type(logical)(_map_logical(fn, t, lg)
                             for t, lg in zip(tree, logical))
    return fn(tree, logical)


def distribute(x, mesh: Mesh, placements) -> Any:
    """The full tensor ``x``, held alike by every rank, as a DTensor on
    ``mesh`` with ``placements``: each rank keeps its shard and nothing is
    sent."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(x).to(mesh.device_mesh.device_type)
    return distribute_tensor(x, mesh.device_mesh, placements,
                             src_data_rank=None)


def shard_pytree(tree, logical_tree, mesh: Mesh,
                 rules: Optional[Dict] = None):
    """Place a parameter tree according to its logical axis tree."""
    return _map_logical(
        lambda x, lg: distribute(x, mesh, logical_to_placements(lg, mesh,
                                                                 rules)),
        tree, logical_tree)


def pytree_sharding(logical_tree, mesh: Mesh, rules: Optional[Dict] = None):
    """The NamedSharding tree of a logical axis tree."""
    return _map_logical(
        lambda _, lg: NamedSharding(mesh, logical_to_spec(lg, rules)),
        logical_tree, logical_tree)


def gather(tree, axes: Sequence[str] = ("fsdp",)):
    """Each DTensor leaf of ``tree`` replicated over the mesh ``axes`` it is
    sharded on (other leaves as they are): the per-layer parameter
    all-gather of ``fsdp`` (ZeRO-3), whose backward reduce-scatters the
    gradients. A layer's weights are gathered before use, so its products
    see weights sharded over ``tensor`` alone."""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return tree

    def one(x):
        if not isinstance(x, mod.DTensor):
            return x
        names = x.device_mesh.mesh_dim_names
        want = [mod.Replicate() if n in axes else p
                for n, p in zip(names, x.placements)]
        return x if tuple(want) == tuple(x.placements) else \
            x.redistribute(x.device_mesh, want)

    return {k: one(v) for k, v in tree.items()}


_lock = threading.Lock()
_stack: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: MeshLike) -> Iterator[Mesh]:
    """Installs ``mesh`` (a ``Mesh`` or a ``MeshSpec``, validated by
    ``make_mesh``) as the ambient mesh for the ``with`` body."""
    mesh = make_mesh(mesh)
    with _lock:
        _stack.append(mesh)
    try:
        yield mesh
    finally:
        with _lock:
            _stack.remove(mesh)


def current_mesh() -> Optional[Mesh]:
    """The innermost ambient mesh, or None."""
    with _lock:
        return _stack[-1] if _stack else None
