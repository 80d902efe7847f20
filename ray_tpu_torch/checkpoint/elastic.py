"""Restore at another world size: place restored host leaves on a device
(the counterpart of ``ray_tpu/checkpoint/elastic.py``).

Shards on disk record the writer's world size, but ``assemble_tree``
already reconciles that into full host tensors — so restoring into a new
world is a placement problem. Each leaf goes either to one device (the
caller's ``device``, else its template leaf's device and dtype) or, given a
device mesh, onto the mesh as a DTensor with a PartitionSpec: one for every
leaf (``pspec``), one per leaf (``pspec_fn``), or ``default_pspec``. Every
rank restores the same host tree and keeps its shard.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np


def default_pspec(leaf: np.ndarray, mesh) -> Any:
    """Shard axis 0 over the mesh's first dimension when it divides evenly;
    replicate otherwise — the mirror of layout.partition_for."""
    from ray_tpu_torch.parallel.mesh import PartitionSpec

    if not mesh.dim_names:
        return PartitionSpec()
    first = mesh.dim_names[0]
    size = mesh.shape[first]
    if leaf.ndim >= 1 and size > 1 and leaf.shape[0] % size == 0:
        return PartitionSpec(first)
    return PartitionSpec()


def _fits(spec, leaf: np.ndarray, mesh) -> bool:
    """Whether ``spec`` shards ``leaf`` evenly (the reference's device_put
    refuses it otherwise, and the restore replicates the leaf)."""
    if len(spec) > leaf.ndim:
        return False
    for dim, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        size = int(np.prod([mesh.shape[n] for n in names]))
        if leaf.shape[dim] % size:
            return False
    return True


def _on_mesh(host_tree: Any, mesh, pspec, pspec_fn) -> Any:
    from torch.utils import _pytree

    from ray_tpu_torch._private.torch_compat import reshard
    from ray_tpu_torch.parallel.mesh import PartitionSpec, make_mesh

    mesh = make_mesh(mesh)

    def place(leaf):
        a = np.asarray(leaf)
        if pspec_fn is not None:
            spec = pspec_fn(a, mesh)
        elif pspec is not None:
            spec = pspec
        else:
            spec = default_pspec(a, mesh)
        return reshard(a, mesh, spec if _fits(spec, a, mesh)
                       else PartitionSpec())

    return _pytree.tree_map(place, host_tree)


def _place(leaf: Any, template: Any, device) -> Any:
    import torch

    if isinstance(template, torch.Tensor):
        return torch.as_tensor(leaf).to(
            device=template.device if device is None else device,
            dtype=template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(leaf.item() if hasattr(leaf, "item") else leaf)
    if device is not None and isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return leaf


def align(tree: Any, template: Any) -> Any:
    """``tree`` with its dicts in ``template``'s key order (a restored
    dict's keys are sorted); raises ValueError where a dict's keys or a
    sequence's length differ."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError("dict keys differ")
        return {k: align(tree[k], template[k]) for k in template}
    if isinstance(template, (list, tuple)) and \
            type(tree) is type(template):
        if len(tree) != len(template):
            raise ValueError("lengths differ")
        items = [align(a, b) for a, b in zip(tree, template)]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree


def reshard_tree(host_tree: Any, mesh=None, pspec: Optional[Any] = None,
                 pspec_fn: Optional[Callable] = None, *, device=None,
                 template: Optional[Any] = None) -> Any:
    """Every leaf of a host tree on ``mesh`` (a ``parallel.Mesh`` or
    ``MeshSpec`` over the process group; ``pspec`` or ``pspec_fn`` choose
    the PartitionSpec, a spec that does not shard a leaf evenly
    replicates it), else on ``device`` (a tensor leaf), or, given
    ``template`` (a tree of the same structure), on each template leaf's
    device and in its dtype (``device`` overrides the device); a Python
    scalar template leaf gives back a Python scalar of its type; dicts
    take the template's key order."""
    if mesh is not None:
        return _on_mesh(host_tree, mesh, pspec, pspec_fn)
    if pspec is not None or pspec_fn is not None:
        raise ValueError("pspec and pspec_fn place leaves on a mesh; "
                         "pass mesh= as well")
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(host_tree)
    if template is None:
        return _pytree.tree_unflatten(
            [_place(leaf, None, device) for leaf in leaves], spec)
    leaves, spec = _pytree.tree_flatten(align(host_tree, template))
    want = _pytree.tree_leaves(template)
    return _pytree.tree_unflatten(
        [_place(leaf, t, device) for leaf, t in zip(leaves, want)], spec)
