"""Parameters between the JAX package's pytree and the port.

The models use one layout on both sides (blocks stacked on a leading layer
axis, weights (in, out)), so their conversion is a copy of every leaf: no
transposes. Trees are nested dicts (GPT-2, Llama, ViT, MoE) and lists (the
MLP's layers). An RLModule's parameters live in the module;
``rl_params_from_numpy`` and ``rl_params_to_numpy`` carry them across by
name, and transpose the one leaf whose layout differs, a conv kernel (HWIO
in JAX, OIHW in torch). A 0-d leaf is a 0-d parameter: SAC's tree (``pi``,
``q1``, ``q2``, ``target_q1``, ``target_q2``, ``log_alpha``) carries across
as it is. DreamerV3's tree (``dreamerv3_params_from_numpy``) also holds
transposed-conv kernels, which go HWIO -> (in, out, kH, kW) flipped in both
spatial axes, and comes with its target critic and bucket grid.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the same nesting of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(params: Any) -> Any:
    """The port's parameters -> the same nesting of numpy arrays (bf16
    leaves come back as float32, since numpy has no bfloat16)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return conv(params)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def rl_params_from_numpy(module: "torch.nn.Module", tree: Any) -> "torch.nn.Module":
    """Load a reference RLModule's params pytree (``jax.tree.map(np.asarray,
    params)``) into the port's ``module``, in place, on its device. Paths
    are the parameter names (``pi.layers.0.w``); conv kernels (the 4-D
    leaves) go HWIO -> OIHW, every other leaf is a copy. Every name must
    match."""
    _load_named(module, tree,
                lambda name, t: t.permute(3, 2, 0, 1) if t.ndim == 4 else t)
    return module


def rl_params_to_numpy(module: "torch.nn.Module") -> Any:
    """The reference's params pytree of the port's ``module``: nested dicts,
    lists where a path part is an index, conv kernels OIHW -> HWIO."""
    return _state_to_tree(
        module.state_dict(),
        lambda name, t: t.permute(2, 3, 1, 0) if t.ndim == 4 else t)


def _state_to_tree(state: Dict[str, "torch.Tensor"], leaf_fn) -> Any:
    """A state dict as the reference's pytree: nested dicts, lists where a
    path part is an index, each leaf ``leaf_fn(name, host tensor)``."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        t = leaf_fn(name, t.detach().cpu())
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t.contiguous().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def _load_named(module: "torch.nn.Module", tree: Any, leaf_fn) -> None:
    """Load a reference pytree into ``module`` by name, each leaf through
    ``leaf_fn(name, tensor)``; every name must match."""
    flat = _flatten(tree)
    names = set(module.state_dict())
    if set(flat) != names:
        raise KeyError(f"params tree does not match the module: missing "
                       f"{sorted(names - set(flat))}, unexpected "
                       f"{sorted(set(flat) - names)}")
    module.load_state_dict({
        name: leaf_fn(name, torch.from_numpy(
            np.array(x, dtype=np.float32, copy=True)))
        for name, x in flat.items()})


def _dreamer_from_ref(name: str, t: "torch.Tensor") -> "torch.Tensor":
    if t.ndim != 4:
        return t
    if ".deconvs." in name:
        # jax.lax.conv_transpose(transpose_kernel=False) does not flip its
        # HWIO kernel; F.conv_transpose2d's (in, out, kH, kW) one does.
        return t.flip(0, 1).permute(2, 3, 0, 1)
    return t.permute(3, 2, 0, 1)


def _dreamer_to_ref(name: str, t: "torch.Tensor") -> "torch.Tensor":
    if t.ndim != 4:
        return t
    if ".deconvs." in name:
        return t.permute(2, 3, 0, 1).flip(0, 1)
    return t.permute(2, 3, 1, 0)


def dreamerv3_params_from_numpy(algo: Any, params: Any, target_critic: Any,
                                buckets: Any = None) -> Any:
    """Load the reference DreamerV3's params tree (``_init_params``'s dict,
    as numpy), its target critic and, given, its bucket grid into the port's
    ``algo`` in place, on its device. Dense ``w`` is (in, out) on both
    sides, the GRU's ``w`` (2D, 3D); conv kernels go HWIO -> OIHW,
    transposed-conv kernels HWIO -> flipped (in, out, kH, kW)."""
    _load_named(algo.model, params, _dreamer_from_ref)
    _load_named(algo.target_critic, target_critic, _dreamer_from_ref)
    if buckets is not None:
        with torch.no_grad():
            algo._head_buckets.copy_(torch.from_numpy(
                np.asarray(buckets, np.float32)))
    return algo


def dreamerv3_params_to_numpy(algo: Any) -> Any:
    """(params, target critic) of the port's DreamerV3 as the reference's
    numpy trees."""
    return (_state_to_tree(algo.model.state_dict(), _dreamer_to_ref),
            _state_to_tree(algo.target_critic.state_dict(), _dreamer_to_ref))
