"""Restore at another world size: place restored host leaves on a device
(the counterpart of ``ray_tpu/checkpoint/elastic.py``).

Shards on disk record the writer's world size, but ``assemble_tree``
already reconciles that into full host tensors — so restoring into a new
world is a placement problem. Here each leaf goes to one device: the
caller's ``device``, else its template leaf's device and dtype. Placing
leaves with shardings of a device mesh (the reference's ``mesh=``,
``pspec=``, ``pspec_fn=``) waits for the port's mesh axes beyond ``seq``
(ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Callable, Optional


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
    """Every leaf of a host tree on ``device`` (a tensor leaf), or, given
    ``template`` (a tree of the same structure), on each template leaf's
    device and in its dtype (``device`` overrides the device); a Python
    scalar template leaf gives back a Python scalar of its type; dicts
    take the template's key order."""
    if mesh is not None or pspec is not None or pspec_fn is not None:
        raise NotImplementedError(
            "restoring onto a device mesh needs the port's data and model "
            "mesh axes (ROADMAP.md, Queue 1 item 3); pass device= instead")
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(host_tree)
    if template is None:
        return _pytree.tree_unflatten(
            [_place(leaf, None, device) for leaf in leaves], spec)
    leaves, spec = _pytree.tree_flatten(align(host_tree, template))
    want = _pytree.tree_leaves(template)
    return _pytree.tree_unflatten(
        [_place(leaf, t, device) for leaf, t in zip(leaves, want)], spec)
