"""A Mixture-of-Experts transformer in PyTorch, on one device: the port of
``ray_tpu/models/moe.py``.

GPT-2's attention block with its MLP replaced by an MoE layer: top-k
token-choice routing with a fixed expert capacity (GShard), an auxiliary
load-balance loss (Switch §2.2: E * sum_e f_e * p_e), and dispatch and
combine as dense products against an (N, E, C) one-hot dispatch tensor, so
every shape is static. Over-capacity tokens are dropped (their combine
weight is zero). On a device mesh (``parallel.create_sharded_state``) the
experts' leading axis is sharded over the ``expert`` axis and the layer
runs as ``_moe_mlp_mesh`` says; with no mesh it computes this same
function on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.torch_compat import Pending, is_dtensor, shard_map
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.optim import AdamW, make_step
from ray_tpu_torch.parallel.mesh import (DEFAULT_RULES, Mesh, gather,
                                         logical_to_spec, partition)

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
                device: DeviceLike = None,
                place: Optional[Callable] = None) -> Params:
    """Random float32 parameters in the JAX package's layout and init scheme
    (GPT-2's, with a router and E experts per block), drawn on ``device``
    from a generator seeded with ``seed``.
    ``place``, given, takes each leaf as it is drawn and gives what the
    tree keeps (``parallel.create_sharded_state`` keeps the rank's shard)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, L, V, S = config.d_model, config.n_layer, config.vocab_size, config.seq_len
    E, F_ = config.n_experts, config.expert_mlp
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def norm(shape, s):
        t = torch.randn(shape, generator=gen, device=dev) * s
        return t if place is None else place(t)

    def const(shape, value):
        t = torch.full(shape, value, dtype=torch.float32, device=dev)
        return t if place is None else place(t)

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
    """The reference's logical axis names per leaf: the experts' leading
    ``expert`` axis is what the mesh's ``expert`` axis shards."""
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


def _plan(probs: torch.Tensor, config: MoEConfig):
    """The routing decisions from (N, E) router probabilities, with no
    gradient: for each of the k choices, the chosen expert, the token's
    (expert, position) slot and whether it is within capacity; and the
    (N, E, C) one-hot dispatch. Ties go to the first maximum, as in JAX.
    Each choice fills one slot, so the slots are scattered instead of
    multiplying one-hots; the sums are the reference's."""
    N, E = probs.shape
    K, C = config.top_k, config.capacity(N)
    dispatch = torch.zeros((N, E * C), dtype=torch.float32,
                           device=probs.device)
    # Running per-expert fill count, carried across the k selections so the
    # 2nd choice lands after all 1st choices of the same expert.
    fill = torch.zeros((E,), dtype=torch.long, device=probs.device)
    masked = probs
    choices, slots, keeps = [], [], []
    for _ in range(K):
        choice = masked.argmax(dim=-1)                     # (N,)
        onehot = F.one_hot(choice, E)                      # (N, E)
        # Position of each token within its chosen expert's buffer.
        pos_in = onehot.cumsum(dim=0) - onehot + fill[None, :]
        pos = (pos_in * onehot).sum(dim=-1)                # (N,)
        keep = pos < C
        # A dropped choice adds 0 to slot 0 of its own row.
        slot = torch.where(keep, choice * C + pos, 0)
        dispatch = dispatch.scatter_add(1, slot[:, None],
                                        keep.float()[:, None])
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        masked = masked * (1.0 - onehot.to(probs.dtype))
        choices.append(choice)
        slots.append(slot)
        keeps.append(keep)
    return (torch.stack(choices), torch.stack(slots), torch.stack(keeps),
            dispatch.view(N, E, C))


def _combine(probs: torch.Tensor, choices: torch.Tensor, slots: torch.Tensor,
             keeps: torch.Tensor, C: int) -> torch.Tensor:
    """(N, E, C) combine weights: each kept choice's router probability in
    its slot, renormalised over the token's kept choices."""
    N, E = probs.shape
    combine = torch.zeros((N, E * C), dtype=torch.float32,
                          device=probs.device)
    for choice, slot, keep in zip(choices, slots, keeps):
        gate = probs.gather(-1, choice[:, None])[:, 0]
        combine = combine.scatter_add(1, slot[:, None], (gate * keep)[:, None])
    combine = combine.view(N, E, C)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    return combine / denom.clamp_min(1e-9)


def _aux(probs: torch.Tensor, top1: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e (token fraction)_e * (mean prob)_e,
    on the top-1 assignment."""
    frac = F.one_hot(top1, E).float().mean(dim=0)
    return E * (frac * probs.mean(dim=0)).sum()


def _route(x32: torch.Tensor, router_w: torch.Tensor, config: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing. x32: (N, D) float32 tokens.

    Returns (dispatch (N, E, C) one-hot, combine (N, E, C) weights, the aux
    load-balance loss)."""
    logits = x32 @ router_w  # (N, E)
    probs = torch.softmax(logits.float(), dim=-1)
    choices, slots, keeps, dispatch = _plan(probs.detach(), config)
    combine = _combine(probs, choices, slots, keeps, dispatch.shape[2])
    return dispatch, combine, _aux(probs, choices[0], config.n_experts)


def _moe_mlp(x: torch.Tensor, blk: Params, config: MoEConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: (B, S, D) -> (B, S, D), plus the aux loss. The
    reference's four einsums as matmuls: dispatch "nec,nd->ecd", the
    experts' "ecd,edf->ecf" and "ecf,efd->ecd", combine "nec,ecd->nd"."""
    if is_dtensor(x):
        return _moe_mlp_mesh(x, blk, config)
    B, S, D = x.shape
    dt = config.dtype
    x2 = x.reshape(B * S, D)
    dispatch, combine, aux = _route(x2.float(), blk["router_w"], config)
    N, E, C = dispatch.shape
    xe = _dispatch(dispatch.to(dt), x2)
    ye = _experts(xe, blk["expert_in_w"], blk["expert_in_b"],
                  blk["expert_out_w"], blk["expert_out_b"], dt)
    y = combine.view(N, E * C).to(dt) @ ye.view(E * C, D)
    return y.view(B, S, D), aux


def _dispatch(dispatch: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """"nec,nd->ecd": each expert's (C, D) buffer of tokens."""
    N, E, C = dispatch.shape
    return (dispatch.view(N, E * C).t() @ x2).view(E, C, x2.shape[1])


def _experts(xe, w_in, b_in, w_out, b_out, dt) -> torch.Tensor:
    """Each expert's MLP over its (C, D) buffer: (E, C, D) -> (E, C, D)."""
    h = torch.bmm(xe, w_in.to(dt))
    h = F.gelu(h + b_in.to(dt)[:, None, :], approximate="tanh")
    return torch.bmm(h, w_out.to(dt)) + b_out.to(dt)[:, None, :]


def _moe_mlp_mesh(x: torch.Tensor, blk: Params, config: MoEConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moe_mlp`` over DTensors on a device mesh, routed over the global
    batch as in the reference: every rank plans the routing from the
    gathered router probabilities (no gradient flows through the plan), and
    the gates come from its own rows. Tokens are sharded over the batch
    axes and replicated over ``expert``, and each rank holds its experts:
    the dispatch product is a sum over batch shards (the experts' buffers
    are all-reduced over them), and the combine product a sum over expert
    shards (left to DTensor as a Partial over ``expert``)."""
    from torch.distributed.tensor import DTensor, Replicate

    B, S, D = x.shape
    dt = config.dtype
    E = config.n_experts
    mesh = Mesh.of(x)
    dm = mesh.device_mesh
    batch = DEFAULT_RULES["batch"]
    rows, whole = logical_to_spec(("batch", None)), partition()
    x2 = x.reshape(B * S, D)

    probs = shard_map(
        lambda x2, w: torch.softmax((x2.float() @ w).float(), dim=-1),
        mesh=mesh, in_specs=(rows, whole), out_specs=rows)(
            x2, blk["router_w"])
    choices, slots, keeps, dispatch = _plan(
        probs.detach().full_tensor(), config)
    C = dispatch.shape[2]

    def rep(t):
        return DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                                  run_check=False)

    plan = logical_to_spec((None, "batch"))
    combine = shard_map(
        partial(_combine, C=C), mesh=mesh,
        in_specs=(rows, plan, plan, plan),
        out_specs=logical_to_spec(("batch", None, None)))(
            probs, rep(choices), rep(slots), rep(keeps))
    frac = rep(F.one_hot(choices[0], E).float().mean(dim=0))
    aux = E * (frac * probs.mean(dim=0)).sum()

    by_expert = logical_to_spec(("batch", "expert", None))
    buffers = logical_to_spec(("expert", None, None))  # and the weights
    xe = shard_map(_dispatch, mesh=mesh, in_specs=(by_expert, rows),
                   out_specs=Pending(buffers, batch))(
                       rep(dispatch.to(dt)), x2)
    ye = shard_map(
        partial(_experts, dt=dt), mesh=mesh,
        in_specs=(buffers, buffers, logical_to_spec(("expert", None)),
                  buffers, logical_to_spec(("expert", None))),
        out_specs=buffers)(xe, blk["expert_in_w"], blk["expert_in_b"],
                           blk["expert_out_w"], blk["expert_out_b"])
    y = shard_map(
        lambda c, ye: c.reshape(c.shape[0], -1).to(dt)
        @ ye.reshape(-1, ye.shape[2]),
        mesh=mesh, in_specs=(by_expert, buffers),
        out_specs=Pending(rows, ("expert",)))(combine, ye)
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


def forward_hidden(params: Params, tokens: torch.Tensor, config: MoEConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (final-layernormed hidden states (B, S, D),
    total aux loss)."""
    dt = config.dtype
    x = gpt2._embed(params["wte"], params["wpe"], tokens, dt)
    block = partial(_block, config=config)
    remat = config.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(config.n_layer):
        blk = gather({name: w[i] for name, w in params["blocks"].items()})
        x, aux = gpt2._ckpt(block, x, blk) if remat else block(x, blk)
        auxes.append(aux)
    x = gpt2._layernorm(x, params["lnf_scale"], params["lnf_bias"]).to(dt)
    return x, torch.stack(auxes).sum()


def forward(params: Params, tokens: torch.Tensor, config: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) float32, total aux loss)."""
    x, aux = forward_hidden(params, tokens, config)
    return gpt2.lm_head(x, params["wte"], torch.float32), aux


def _ce(x: torch.Tensor, targets: torch.Tensor, wte: torch.Tensor
        ) -> torch.Tensor:
    logits = gpt2.lm_head(x, wte, torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).mean()


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            config: MoEConfig) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``aux_loss_weight`` x the aux
    loss summed over layers."""
    x, aux = forward_hidden(params, tokens, config)
    return gpt2.sharded_mean(_ce, x, targets, params["wte"]) \
        + config.aux_loss_weight * aux


def make_train_step(config: MoEConfig, optimizer: AdamW):
    """(params, opt_state, tokens, targets) -> (params, opt_state, loss)
    (``optim.make_step``)."""
    return make_step(partial(loss_fn, config=config), optimizer)
