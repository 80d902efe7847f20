"""A small MLP classifier in PyTorch: the port of ``ray_tpu/models/mlp.py``
(the fashion-MNIST workload, BASELINE config 1).

The parameters are the JAX package's layout, a list of ``{"w": (d_in,
d_out), "b": (d_out,)}`` dicts, one per layer, used as ``x @ w + b``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device

Params = List[Dict[str, torch.Tensor]]


def init_params(seed: int = 0, sizes: Sequence[int] = (784, 128, 64, 10),
                device: DeviceLike = None) -> Params:
    """He init (normal * sqrt(2 / d_in)) and zero biases, float32, drawn on
    ``device`` from a generator seeded with ``seed`` (the numbers differ
    from JAX's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{"w": torch.randn((d_in, d_out), generator=gen, device=dev)
             * (2.0 / d_in) ** 0.5,
             "b": torch.zeros((d_out,), device=dev)}
            for d_in, d_out in zip(sizes[:-1], sizes[1:])]


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(N, sizes[0]) -> logits (N, sizes[-1]), ReLU between the layers."""
    for layer in params[:-1]:
        x = F.relu(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels ``y`` under log_softmax."""
    logp = F.log_softmax(forward(params, x), dim=-1)
    return -logp.gather(-1, y[:, None].long()).mean()


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (forward(params, x).argmax(-1) == y).float().mean()
