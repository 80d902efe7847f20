"""Llama in PyTorch: the port of ``ray_tpu/models/llama.py`` (RMSNorm,
rotary position embedding, SwiGLU and grouped-query attention).

The module mirrors the port's ``gpt2.py``: plain functions on tensors over
the JAX package's parameter layout (blocks stacked on a leading layer axis,
weights (in, out) used as ``x @ W``, held in float32 and cast to
``config.dtype`` at each matmul). Attention goes through GPT-2's dispatcher
(``gpt2._attention``), as the reference reuses its own, so every
``attn_impl`` works: on CUDA tensors "auto", "splash" and "pallas" run the
splash kernels, "ring" the ring kernels under ``use_mesh(MeshSpec(seq=W))``
(or across process ranks on a mesh whose ``seq`` axis spans them, where
RoPE takes each rank's global positions).
The kernels take full-head k and v: grouped-query attention repeats each kv
head for its query heads before the call.
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
from ray_tpu_torch.models import gpt2 as _g
from ray_tpu_torch.optim import AdamW, make_step
from ray_tpu_torch.optim import make_optimizer as _make_optimizer
from ray_tpu_torch.parallel.mesh import Mesh, gather

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 8
    n_head: int = 8
    #: grouped-query attention: kv heads < query heads share k/v
    n_kv_head: int = 4
    d_model: int = 512
    #: SwiGLU hidden dim (Llama uses ~8/3 * d_model rounded to 256)
    d_ff: int = 1408
    seq_len: int = 1024
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    #: Each layer checkpointed whole (``torch.utils.checkpoint``): the
    #: backward reruns its forward, attention included.
    remat: bool = True
    attn_impl: str = "auto"  # auto | xla | pallas | splash | ring | ulysses
    #: The TPU splash kernel's tile sizes; the Hopper kernels ignore them.
    attn_block_q: int = 512
    attn_block_kv: int = 512
    logits_dtype: torch.dtype = torch.bfloat16
    #: Pipeline stages; only 1 until the pipeline-parallel port.
    pp_stages: int = 1
    pp_microbatches: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_kv_head

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=1024, n_layer=2, n_head=4, n_kv_head=2,
                           d_model=128, d_ff=384, seq_len=128)

    def __post_init__(self):
        assert self.d_model % self.n_head == 0
        assert self.n_head % self.n_kv_head == 0


def init_params(config: LlamaConfig, seed: int = 0,
                device: DeviceLike = None,
                place: Optional[Callable] = None) -> Params:
    """Random float32 parameters in the JAX package's layout and init scheme:
    normal(0.02) weights, residual projections at 0.02/sqrt(2L), unit norm
    scales, an untied LM head. Drawn on ``device`` from a generator seeded
    with ``seed`` (the numbers differ from JAX's).
    ``place``, given, takes each leaf as it is drawn and gives what the
    tree keeps (``parallel.create_sharded_state`` keeps the rank's shard)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, L, V = config.d_model, config.n_layer, config.vocab_size
    H, KV, hd, F_ = config.n_head, config.n_kv_head, config.head_dim, config.d_ff
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def norm(shape, s):
        t = torch.randn(shape, generator=gen, device=dev) * s
        return t if place is None else place(t)

    def ones(shape):
        t = torch.ones(shape, device=dev)
        return t if place is None else place(t)

    return {
        "wte": norm((V, D), std),
        "blocks": {
            "attn_norm": ones((L, D)),
            "wq": norm((L, D, H * hd), std),
            "wk": norm((L, D, KV * hd), std),
            "wv": norm((L, D, KV * hd), std),
            "wo": norm((L, H * hd, D), resid_std),
            "mlp_norm": ones((L, D)),
            "w_gate": norm((L, D, F_), std),
            "w_up": norm((L, D, F_), std),
            "w_down": norm((L, F_, D), resid_std),
        },
        "final_norm": ones((D,)),
        "lm_head": norm((V, D), std),
    }


def logical_axes(config: LlamaConfig) -> Dict[str, Any]:
    """The reference's logical axis names per leaf: what
    ``parallel.create_sharded_state`` places each leaf by."""
    L = "layers"
    return {
        "wte": ("vocab", "embed"),
        "blocks": {
            "attn_norm": (L, "norm"),
            "wq": (L, "embed", "heads"),
            "wk": (L, "embed", "heads"),
            "wv": (L, "embed", "heads"),
            "wo": (L, "heads", "embed"),
            "mlp_norm": (L, "norm"),
            "w_gate": (L, "embed", "mlp"),
            "w_up": (L, "embed", "mlp"),
            "w_down": (L, "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("vocab", "embed"),
    }


def num_params(config: LlamaConfig) -> int:
    D, L, V, F_ = (config.d_model, config.n_layer, config.vocab_size,
                   config.d_ff)
    hd = config.head_dim
    attn = D * config.n_head * hd + 2 * D * config.n_kv_head * hd \
        + config.n_head * hd * D
    mlp = 3 * D * F_
    per_block = 2 * D + attn + mlp
    return 2 * V * D + L * per_block + D


def flops_per_token(config: LlamaConfig) -> float:
    return 6.0 * num_params(config) \
        + 12.0 * config.n_layer * config.d_model * config.seq_len


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """float32 RMSNorm; returns float32 (the caller casts)."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    return x32 * torch.rsqrt(ms + eps) * scale


def _rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary position embedding over (B, S, H, hd), rotate-half form, in
    float32 and cast back to x's type; ``offset`` is the global position of
    the first row (a ``seq`` shard's)."""
    B, S, H, hd = x.shape
    half = hd // 2
    dev = x.device
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=dev) / half))
    angles = torch.arange(offset, offset + S, dtype=torch.float32,
                          device=dev)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]  # (1, S, 1, half)
    sin = torch.sin(angles)[None, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            config: LlamaConfig, offset: int = 0,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """RoPE, GQA's shared kv heads and causal attention over (B, S, H, hd)
    (KV heads for k and v), the first row at global position ``offset``. On
    a device mesh it runs over each rank's batch shard and heads (a rank's
    kv heads are those its query heads read), and over its sequence shard
    on the context-parallel paths."""
    q = _rope(q, config.rope_theta, offset)
    k = _rope(k, config.rope_theta, offset)
    if config.n_kv_head != config.n_head:
        # GQA: kv head j serves query heads j*q_per_kv .. (j+1)*q_per_kv - 1
        # (jnp.repeat; Tensor.repeat would tile the heads instead).
        k = k.repeat_interleave(config.q_per_kv, dim=2)
        v = v.repeat_interleave(config.q_per_kv, dim=2)
    return _g._attention(q, k, v, config, mesh)


def _block(x: torch.Tensor, blk: Params, config: LlamaConfig) -> torch.Tensor:
    dt = config.dtype
    B, S, D = x.shape
    H, KV, hd = config.n_head, config.n_kv_head, config.head_dim

    h = _rmsnorm(x, blk["attn_norm"], config.rms_eps).to(dt)
    q = _g._mm(h, blk["wq"].to(dt)).view(B, S, H, hd)
    k = _g._mm(h, blk["wk"].to(dt)).view(B, S, KV, hd)
    v = _g._mm(h, blk["wv"].to(dt)).view(B, S, KV, hd)
    if is_dtensor(q):
        mesh = Mesh.of(q)
        spec = _g._qkv_spec(config)
        attn = shard_map(partial(_attend, config=config,
                                 offset=_g._seq_offset(mesh, spec, S),
                                 mesh=mesh),
                         mesh=mesh, in_specs=(spec,) * 3,
                         out_specs=spec)(q, k, v)
    else:
        attn = _attend(q, k, v, config)
    attn = attn.to(dt).reshape(B, S, H * hd)
    x = x + _g._mm(attn, blk["wo"].to(dt))

    h = _rmsnorm(x, blk["mlp_norm"], config.rms_eps).to(dt)
    gate = F.silu(_g._mm(h, blk["w_gate"].to(dt)).float())
    up = _g._mm(h, blk["w_up"].to(dt)).float()
    return x + _g._mm((gate * up).to(dt), blk["w_down"].to(dt))


def _validate(config: LlamaConfig) -> None:
    if config.pp_stages > 1:
        raise NotImplementedError(
            "pp_stages > 1 (pipeline parallelism) is not ported yet; see "
            "ROADMAP.md")


def forward_hidden(params: Params, tokens: torch.Tensor,
                   config: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) int -> final-normed hidden states (B, S, D) in
    ``config.dtype``."""
    _validate(config)
    x = _g._embed(params["wte"], None, tokens, config.dtype)
    block = partial(_block, config=config)
    # jax.checkpoint(layer): checkpointing only matters when a backward runs.
    remat = config.remat and torch.is_grad_enabled()
    for i in range(config.n_layer):
        blk = gather({name: w[i] for name, w in params["blocks"].items()})
        x = _g._ckpt(block, x, blk) if remat else block(x, blk)
    return _rmsnorm(x, params["final_norm"], config.rms_eps).to(config.dtype)


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig
            ) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    x = forward_hidden(params, tokens, config)
    return _g.lm_head(x, params["lm_head"], torch.float32)


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """Mean next-token cross-entropy: logits in ``config.logits_dtype``
    (bf16 by default), their logsumexp and the target logit in float32."""
    x = forward_hidden(params, tokens, config)

    def mean(x, targets, w):
        B, S, _ = x.shape
        return _g._ce_sum(x, w, targets, config.logits_dtype) / (B * S)

    return _g.sharded_mean(mean, x, targets, params["lm_head"])


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> AdamW:
    """GPT-2's optimizer: global-norm clipping, AdamW with a bf16 first
    moment."""
    return _make_optimizer(learning_rate=learning_rate,
                           weight_decay=weight_decay, b1=b1, b2=b2,
                           grad_clip=grad_clip)


def make_train_step(config: LlamaConfig, optimizer: AdamW):
    """(params, opt_state, tokens, targets) -> (params, opt_state, loss),
    GPT-2's contract (``optim.make_step``)."""
    _validate(config)
    return make_step(partial(loss_fn, config=config), optimizer)
