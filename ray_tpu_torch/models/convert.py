"""Parameters between the JAX package's pytree and the port.

The models use one layout on both sides (blocks stacked on a leading layer
axis, weights (in, out)), so their conversion is a copy of every leaf: no
transposes. Trees are nested dicts (GPT-2, Llama, ViT, MoE) and lists (the
MLP's layers). An RLModule's parameters live in the module;
``rl_params_from_numpy`` and ``rl_params_to_numpy`` carry them across by
name, and transpose the one leaf whose layout differs, a conv kernel (HWIO
in JAX, OIHW in torch).
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
    flat = _flatten(tree)
    names = set(module.state_dict())
    if set(flat) != names:
        raise KeyError(f"params tree does not match the module: missing "
                       f"{sorted(names - set(flat))}, unexpected "
                       f"{sorted(set(flat) - names)}")
    state = {}
    for name, x in flat.items():
        t = torch.from_numpy(np.array(x, dtype=np.float32, copy=True))
        state[name] = t.permute(3, 2, 0, 1) if t.ndim == 4 else t
    module.load_state_dict(state)
    return module


def rl_params_to_numpy(module: "torch.nn.Module") -> Any:
    """The reference's params pytree of the port's ``module``: nested dicts,
    lists where a path part is an index, conv kernels OIHW -> HWIO."""
    tree: Dict[str, Any] = {}
    for name, t in module.state_dict().items():
        t = t.detach().cpu()
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
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
