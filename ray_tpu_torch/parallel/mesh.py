"""Named parallelism axes and the ambient mesh: the port of
``ray_tpu/parallel/mesh.py``.

``AXIS_NAMES`` and ``MeshSpec`` are the JAX package's, copied (the port
imports nothing of ``ray_tpu``). What differs is what a mesh is. In JAX it is
a grid of devices that ``shard_map`` splits arrays over. Here, for now, every
axis is folded onto the one device of the process: a ``seq`` axis of size W
means that the tensors hold all W sequence shards side by side and the
context-parallel attention (``ops/ring_attention.py``) runs its W ranks as
kernel launches over them. ``make_mesh`` therefore accepts ``seq`` >= 1 and
every other axis at 1; a ``data``, ``fsdp``, ``tensor``, ``pipe`` or
``expert`` axis above 1 would shard nothing in one process and raises
(ROADMAP Queue 1 items 3 and 7 bring processes and a device mesh).

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
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Union

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


@dataclass(frozen=True)
class Mesh:
    """A validated ``MeshSpec`` folded onto one device. ``shape`` maps each
    axis name to its size, as a JAX mesh's does."""

    spec: MeshSpec

    @property
    def axis_names(self):
        return AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.axis_sizes()

    @property
    def size(self) -> int:
        return self.spec.size


MeshLike = Union[Mesh, MeshSpec]


def make_mesh(spec: MeshLike) -> Mesh:
    """The mesh of ``spec`` with its axes folded onto this process's device.

    Only the ``seq`` axis may exceed 1: it is the one whose ranks the
    port runs side by side on one device. Any other axis above 1 raises
    ``NotImplementedError``.
    """
    if isinstance(spec, Mesh):
        return spec
    sizes = spec.axis_sizes()
    bad = {n: s for n, s in sizes.items() if s < 1}
    if bad:
        raise ValueError(f"mesh axes must be >= 1, got {bad}")
    wide = {n: s for n, s in sizes.items() if n != "seq" and s > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} above 1: the port folds only the seq axis onto "
            "one device; data, fsdp, tensor, pipe and expert axes need "
            "processes and a device mesh (ROADMAP Queue 1 items 3 and 7)")
    return Mesh(spec)


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
