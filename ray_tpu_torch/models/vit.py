"""ViT in PyTorch: the port of ``ray_tpu/models/vit.py`` (a Vision
Transformer for image classification, Dosovitskiy et al. 2020).

Same functional contract as the port's language models: ``init_params /
logical_axes / forward / loss_fn / make_train_step`` over the JAX package's
parameter layout. Patches are unfolded by reshape and permute, and the patch
embedding is one matmul. Matmuls run in ``config.dtype`` (bf16 by default),
layernorms and softmax in float32 (each cast back to its input's type), and
the classifier head in float32. The block's attention is the plain
einsum-softmax-einsum of the reference, which runs no kernel for it either.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.torch_compat import is_dtensor, shard_map
from ray_tpu_torch.models.gpt2 import sharded_mean
from ray_tpu_torch.optim import AdamW, make_step
from ray_tpu_torch.parallel.mesh import (Mesh, gather, logical_to_spec,
                                         partition)

Params = Dict[str, Any]


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    #: lax.scan over the layer axis or an unrolled loop in JAX; the port
    #: always runs the layers as a Python loop, so it has no effect.
    scan_layers: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size * self.patch_size

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, num_classes=10,
                   d_model=64, n_layer=2, n_head=4, d_ff=128)

    @classmethod
    def base(cls) -> "ViTConfig":
        return cls()  # ViT-B/16


def init_params(config: ViTConfig, seed: int = 0,
                device: DeviceLike = None,
                place: Optional[Callable] = None) -> Params:
    """Random float32 parameters in the JAX package's layout: normal(0.02)
    weights and embeddings, unit layernorm scales, zero biases. Drawn on
    ``device`` from a generator seeded with ``seed``.
    ``place``, given, takes each leaf as it is drawn and gives what the
    tree keeps (``parallel.create_sharded_state`` keeps the rank's shard)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, L, F_ = config.d_model, config.n_layer, config.d_ff
    P, C, N = config.patch_dim, config.num_classes, config.n_patches

    def dense(shape):
        t = torch.randn(shape, generator=gen, device=dev) * 0.02
        return t if place is None else place(t)

    def const(shape, value):
        t = torch.full(shape, value, dtype=torch.float32, device=dev)
        return t if place is None else place(t)

    blocks = {
        "ln1_scale": const((L, D), 1.0), "ln1_bias": const((L, D), 0.0),
        "wqkv": dense((L, D, 3 * D)),
        "wo": dense((L, D, D)),
        "ln2_scale": const((L, D), 1.0), "ln2_bias": const((L, D), 0.0),
        "w_up": dense((L, D, F_)), "b_up": const((L, F_), 0.0),
        "w_down": dense((L, F_, D)), "b_down": const((L, D), 0.0),
    }
    return {
        "patch_embed": dense((P, D)),
        "patch_bias": const((D,), 0.0),
        "pos_embed": dense((N + 1, D)),
        "cls_token": dense((1, D)),
        "blocks": blocks,
        "lnf_scale": const((D,), 1.0), "lnf_bias": const((D,), 0.0),
        "head": dense((D, C)), "head_bias": const((C,), 0.0),
    }


def logical_axes(config: ViTConfig) -> Dict[str, Any]:
    """The reference's logical axis names per leaf: what
    ``parallel.create_sharded_state`` places each leaf by."""
    L = "layers"
    return {
        "patch_embed": ("patch", "embed"),
        "patch_bias": ("embed",),
        "pos_embed": ("seq_pos", "embed"),
        "cls_token": (None, "embed"),
        "blocks": {
            "ln1_scale": (L, "norm"), "ln1_bias": (L, "norm"),
            "wqkv": (L, "embed", "heads"),
            "wo": (L, "heads", "embed"),
            "ln2_scale": (L, "norm"), "ln2_bias": (L, "norm"),
            "w_up": (L, "embed", "mlp"), "b_up": (L, "mlp"),
            "w_down": (L, "mlp", "embed"), "b_down": (L, "norm"),
        },
        "lnf_scale": ("norm",), "lnf_bias": ("norm",),
        "head": ("embed", "vocab"), "head_bias": ("vocab",),
    }


def num_params(config: ViTConfig) -> int:
    D, L, F_ = config.d_model, config.n_layer, config.d_ff
    per_block = 4 * D + 3 * D * D + D * D + D * F_ + F_ + F_ * D + D
    return (config.patch_dim * D + D + (config.n_patches + 1) * D + D
            + L * per_block + 2 * D + D * config.num_classes
            + config.num_classes)


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """float32 layernorm (population variance), returned in x's type."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def patchify(images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, patch_dim): row-major patches, each its
    row-major pixels with RGB last."""
    B = images.shape[0]
    p = config.patch_size
    g = config.image_size // p
    x = images.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * g, p * p * 3)


#: The layout of q, k, v and the attention output, (B, T, H, hd), on a mesh.
_QKV_AXES = ("batch", "seqlen", "heads", "kv")


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """Bidirectional attention over (B, T, H, hd) with softmax in float32;
    on a device mesh, over each rank's batch shard and heads."""
    dt = q.dtype
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (q @ k.transpose(-1, -2)).float()
    scores = scores / math.sqrt(q.shape[-1])
    attn = torch.softmax(scores, dim=-1).to(dt)
    return (attn @ v).transpose(1, 2)


def _block(x: torch.Tensor, blk: Params, config: ViTConfig) -> torch.Tensor:
    B, T, D = x.shape
    H = config.n_head
    dt = x.dtype
    h = _layernorm(x, blk["ln1_scale"], blk["ln1_bias"])
    qkv = h @ blk["wqkv"].to(dt)
    q, k, v = (t.reshape(B, T, H, D // H) for t in qkv.split(D, dim=-1))
    if is_dtensor(q):
        spec = logical_to_spec(_QKV_AXES)
        out = shard_map(_attend, mesh=Mesh.of(q), in_specs=(spec,) * 3,
                        out_specs=spec)(q, k, v)
    else:
        out = _attend(q, k, v)
    x = x + out.reshape(B, T, D) @ blk["wo"].to(dt)
    h = _layernorm(x, blk["ln2_scale"], blk["ln2_bias"])
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(h @ blk["w_up"].to(dt) + blk["b_up"].to(dt),
               approximate="tanh")
    return x + h @ blk["w_down"].to(dt) + blk["b_down"].to(dt)


def forward(params: Params, images: torch.Tensor, config: ViTConfig
            ) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, num_classes) logits (float32)."""
    x = forward_hidden(params, images, config)
    return _head(x, params["head"], params["head_bias"])


_EMBED = ("patch_embed", "patch_bias", "cls_token", "pos_embed")


def _embed(images: torch.Tensor, weights, config: ViTConfig) -> torch.Tensor:
    """Patches, their projection, the class token and the positions: (B,
    n_patches + 1, D). On a device mesh each rank embeds its batch shard
    with the whole (gathered) weights."""
    if is_dtensor(images):
        return shard_map(
            lambda images, *w: _embed(images, w, config),
            mesh=Mesh.of(images),
            in_specs=(logical_to_spec(("batch", None, None, None)),)
            + (partition(),) * len(weights),
            out_specs=logical_to_spec(("batch", None, None)))(images,
                                                               *weights)
    patch_embed, patch_bias, cls_token, pos_embed = weights
    dt = config.dtype
    x = patchify(images.to(dt), config)
    x = x @ patch_embed.to(dt) + patch_bias.to(dt)
    B = x.shape[0]
    cls = cls_token.to(dt).expand(B, 1, config.d_model)
    x = torch.cat([cls, x], dim=1)
    return x + pos_embed.to(dt)


def forward_hidden(params: Params, images: torch.Tensor, config: ViTConfig
                   ) -> torch.Tensor:
    """(B, H, W, 3) images -> final-layernormed tokens (B, n_patches + 1,
    D) in ``config.dtype``."""
    x = _embed(images, [params[n] for n in _EMBED], config)
    for i in range(config.n_layer):
        x = _block(x, gather({n: w[i] for n, w in params["blocks"].items()}),
                   config)
    return _layernorm(x, params["lnf_scale"], params["lnf_bias"])


def _head(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """The class token's logits (B, num_classes), float32."""
    return x[:, 0].float() @ w + b


def _nll(x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
         b: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(_head(x, w, b), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            config: ViTConfig) -> torch.Tensor:
    x = forward_hidden(params, images, config)
    return sharded_mean(_nll, x, labels, params["head"], params["head_bias"])


def accuracy(params: Params, images: torch.Tensor, labels: torch.Tensor,
             config: ViTConfig) -> torch.Tensor:
    logits = forward(params, images, config)
    return (logits.argmax(-1) == labels).float().mean()


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.05,
                   b1: float = 0.9, b2: float = 0.999) -> AdamW:
    """``optax.adamw(lr, b1, b2, weight_decay)``: no clip and a float32
    first moment (unlike the language models' optimizer)."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 b1=b1, b2=b2, grad_clip=math.inf, mu_dtype=torch.float32)


def make_train_step(config: ViTConfig, optimizer: AdamW):
    """(params, opt_state, images, labels) -> (params, opt_state, loss)
    (``optim.make_step``)."""
    return make_step(partial(loss_fn, config=config), optimizer)
