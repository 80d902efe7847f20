"""Parameters between the JAX package's pytree and the port.

Both sides use one layout (blocks stacked on a leading layer axis, weights
(in, out)), so conversion is a copy of every leaf: no transposes. Trees are
nested dicts (GPT-2, Llama, ViT, MoE) and lists (the MLP's layers).
"""

from __future__ import annotations

from typing import Any

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
