"""A Mixture-of-Experts transformer in PyTorch, on one device: the port of
``ray_tpu/models/moe.py``.

GPT-2's attention block with its MLP replaced by an MoE layer: top-k
token-choice routing with a fixed expert capacity (GShard), an auxiliary
load-balance loss (Switch §2.2: E * sum_e f_e * p_e), and dispatch and
combine as dense products against an (N, E, C) one-hot dispatch tensor, so
every shape is static. Over-capacity tokens are dropped (their combine
weight is zero). The reference shards the experts' leading axis over its
``expert`` mesh axis, where XLA turns the dispatch products into an
all_to_all; with no mesh it computes this same function on one device.
The port has no ``expert`` axis yet (ROADMAP.md, Queue 1 item 3), and a
mesh with one raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.optim import AdamW, make_step
from ray_tpu_torch.parallel.mesh import current_mesh

Params = Dict[str, Any]


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32768
    n_layer: int = 8
    n_head: int = 8
    d_model: int = 512
    seq_len: int = 1024
    n_experts: int = 8
    expert_mlp: int = 1024  # per-expert hidden width
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    #: Each block checkpointed whole, as ``jax.checkpoint(block_fn)``.
    remat: bool = True
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token capacity C, padded to a multiple of 8 for tiling."""
        c = int(math.ceil(self.capacity_factor * self.top_k * n_tokens
                          / self.n_experts))
        return max(8, -(-c // 8) * 8)

    @staticmethod
    def tiny() -> "MoEConfig":
        return MoEConfig(vocab_size=1024, n_layer=2, n_head=4, d_model=128,
                         seq_len=64, n_experts=4, expert_mlp=256)

    def _attn_view(self) -> gpt2.GPTConfig:
        """GPTConfig view so the attention kernel selection is shared."""
        return gpt2.GPTConfig(
            vocab_size=self.vocab_size, n_layer=self.n_layer,
            n_head=self.n_head, d_model=self.d_model, seq_len=self.seq_len,
            dtype=self.dtype, attn_impl=self.attn_impl)


def init_params(config: MoEConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random float32 parameters in the JAX package's layout and init scheme
    (GPT-2's, with a router and E experts per block), drawn on ``device``
    from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, L, V, S = config.d_model, config.n_layer, config.vocab_size, config.seq_len
    E, F_ = config.n_experts, config.expert_mlp
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def norm(shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "wte": norm((V, D), std),
        "wpe": norm((S, D), std / 2),
        "blocks": {
            "ln1_scale": const((L, D), 1.0),
            "ln1_bias": const((L, D), 0.0),
            "qkv_w": norm((L, D, 3 * D), std),
            "qkv_b": const((L, 3 * D), 0.0),
            "out_w": norm((L, D, D), resid_std),
            "out_b": const((L, D), 0.0),
            "ln2_scale": const((L, D), 1.0),
            "ln2_bias": const((L, D), 0.0),
            "router_w": norm((L, D, E), std),
            "expert_in_w": norm((L, E, D, F_), std),
            "expert_in_b": const((L, E, F_), 0.0),
            "expert_out_w": norm((L, E, F_, D), resid_std),
            "expert_out_b": const((L, E, D), 0.0),
        },
        "lnf_scale": const((D,), 1.0),
        "lnf_bias": const((D,), 0.0),
    }


def logical_axes(config: MoEConfig) -> Dict[str, Any]:
    """The reference's logical axis names per leaf, as data: the experts'
    leading ``expert`` axis is what its mesh shards (ROADMAP.md, Queue 1
    item 3)."""
    La = "layers"
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1_scale": (La, "norm"),
            "ln1_bias": (La, "norm"),
            "qkv_w": (La, "embed", "heads"),
            "qkv_b": (La, "heads"),
            "out_w": (La, "heads", "embed"),
            "out_b": (La, "norm"),
            "ln2_scale": (La, "norm"),
            "ln2_bias": (La, "norm"),
            "router_w": (La, "embed", None),
            "expert_in_w": (La, "expert", "embed", "mlp"),
            "expert_in_b": (La, "expert", "mlp"),
            "expert_out_w": (La, "expert", "mlp", "embed"),
            "expert_out_b": (La, "expert", "norm"),
        },
        "lnf_scale": ("norm",),
        "lnf_bias": ("norm",),
    }


def num_params(config: MoEConfig) -> int:
    D, L, V, S = config.d_model, config.n_layer, config.vocab_size, config.seq_len
    E, F_ = config.n_experts, config.expert_mlp
    attn = 4 * D + 3 * D * D + 3 * D + D * D + D
    moe = D * E + E * D * F_ + E * F_ + E * F_ * D + E * D
    return V * D + S * D + L * (attn + moe) + 2 * D


def _route(x32: torch.Tensor, router_w: torch.Tensor, config: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing. x32: (N, D) float32 tokens.

    Returns (dispatch (N, E, C) one-hot, combine (N, E, C) weights, the aux
    load-balance loss). Ties go to the first maximum, as in JAX. Each
    choice fills one (expert, position) slot, so the slots are scattered
    instead of multiplying one-hots; the sums are the reference's.
    """
    N = x32.shape[0]
    E, K = config.n_experts, config.top_k
    C = config.capacity(N)

    logits = x32 @ router_w  # (N, E)
    probs = torch.softmax(logits.float(), dim=-1)

    # Switch-style aux loss: E * sum_e (token fraction)_e * (mean prob)_e,
    # on the top-1 assignment.
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, E).float().mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()

    dispatch = torch.zeros((N, E * C), dtype=torch.float32, device=x32.device)
    combine = torch.zeros_like(dispatch)
    # Running per-expert fill count, carried across the k selections so the
    # 2nd choice lands after all 1st choices of the same expert.
    fill = torch.zeros((E,), dtype=torch.long, device=x32.device)
    masked = probs
    for _ in range(K):
        choice = masked.argmax(dim=-1)                     # (N,)
        gate = masked.gather(-1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, E)                      # (N, E)
        # Position of each token within its chosen expert's buffer.
        pos_in = onehot.cumsum(dim=0) - onehot + fill[None, :]
        pos = (pos_in * onehot).sum(dim=-1)                # (N,)
        keep = pos < C
        # A dropped choice adds 0 to slot 0 of its own row.
        slot = torch.where(keep, choice * C + pos, 0)[:, None]
        dispatch = dispatch.scatter_add(1, slot, keep.float()[:, None])
        combine = combine.scatter_add(1, slot, (gate * keep)[:, None])
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        masked = masked * (1.0 - onehot.to(probs.dtype))
    dispatch, combine = dispatch.view(N, E, C), combine.view(N, E, C)
    # Renormalise the combine weights over the kept choices per token.
    denom = combine.sum(dim=(1, 2), keepdim=True)
    return dispatch, combine / denom.clamp_min(1e-9), aux


def _moe_mlp(x: torch.Tensor, blk: Params, config: MoEConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: (B, S, D) -> (B, S, D), plus the aux loss. The
    reference's four einsums as matmuls: dispatch "nec,nd->ecd", the
    experts' "ecd,edf->ecf" and "ecf,efd->ecd", combine "nec,ecd->nd"."""
    B, S, D = x.shape
    dt = config.dtype
    x2 = x.reshape(B * S, D)
    dispatch, combine, aux = _route(x2.float(), blk["router_w"], config)
    N, E, C = dispatch.shape
    xe = (dispatch.view(N, E * C).to(dt).t() @ x2).view(E, C, D)
    h = torch.bmm(xe, blk["expert_in_w"].to(dt))
    h = F.gelu(h + blk["expert_in_b"].to(dt)[:, None, :], approximate="tanh")
    ye = torch.bmm(h, blk["expert_out_w"].to(dt))
    ye = ye + blk["expert_out_b"].to(dt)[:, None, :]
    y = combine.view(N, E * C).to(dt) @ ye.view(E * C, D)
    return y.view(B, S, D), aux


def _block(x: torch.Tensor, blk: Params, config: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    H, hd = config.n_head, config.head_dim
    dt = config.dtype

    h = gpt2._layernorm(x, blk["ln1_scale"], blk["ln1_bias"]).to(dt)
    qkv = h @ blk["qkv_w"].to(dt) + blk["qkv_b"].to(dt)
    # Views into qkv with a row stride of 3*D; the kernel takes them as is.
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(D, dim=-1))
    attn = gpt2._attention(q, k, v, config._attn_view())
    x = x + attn.reshape(B, S, D) @ blk["out_w"].to(dt) + blk["out_b"].to(dt)

    h = gpt2._layernorm(x, blk["ln2_scale"], blk["ln2_bias"]).to(dt)
    y, aux = _moe_mlp(h, blk, config)
    return x + y, aux


def _check_mesh() -> None:
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("expert", 1) > 1:
        raise NotImplementedError(
            "MoE with the experts sharded over an 'expert' mesh axis is not "
            "ported yet (ROADMAP.md, Queue 1 item 3); run it with no expert "
            "axis, which computes the same function on one device")


def forward(params: Params, tokens: torch.Tensor, config: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) float32, total aux loss)."""
    _check_mesh()
    B, S = tokens.shape
    dt = config.dtype
    x = params["wte"][tokens].to(dt) + params["wpe"][:S].to(dt)
    block = partial(_block, config=config)
    remat = config.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(config.n_layer):
        blk = {name: w[i] for name, w in params["blocks"].items()}
        x, aux = gpt2._ckpt(block, x, blk) if remat else block(x, blk)
        auxes.append(aux)
    x = gpt2._layernorm(x, params["lnf_scale"], params["lnf_bias"]).to(dt)
    return gpt2.lm_head(x, params["wte"], torch.float32), \
        torch.stack(auxes).sum()


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            config: MoEConfig) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``aux_loss_weight`` x the aux
    loss summed over layers."""
    logits, aux = forward(params, tokens, config)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).mean() + config.aux_loss_weight * aux


def make_train_step(config: MoEConfig, optimizer: AdamW):
    """(params, opt_state, tokens, targets) -> (params, opt_state, loss)
    (``optim.make_step``)."""
    return make_step(partial(loss_fn, config=config), optimizer)
