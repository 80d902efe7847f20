"""GPT-2 in PyTorch: the port of ``ray_tpu/models/gpt2.py``.

Parameters keep the JAX package's layout, so the converter between the two is
a plain copy: a dictionary of tensors with the blocks stacked on a leading
layer axis and every weight stored (in, out) and used as ``x @ W``. Weights
are held in float32 and each matmul casts its operands to ``config.dtype``;
layernorm, softmax and the loss reductions run in float32.

``forward``, ``forward_hidden`` and ``loss_fn`` serve evaluation and
serving; ``make_train_step`` (with ``make_optimizer``, from
``ray_tpu_torch.optim``) and ``make_eval_step`` are the training step.
Gradients come from autograd: attention differentiates through the splash
kernels' own backward (``SplashAttention``) or, with ``attn_impl="ring"``,
the ring kernels' (``FusedRing``), the fused loss through the
fused cross-entropy kernels (``FusedCE``), and remat is
``torch.utils.checkpoint``. The layers always run as a Python loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch._private.torch_compat import Pending, is_dtensor, shard_map
from ray_tpu_torch.ops.attention import (attention_reference, flash_attention,
                                         splash_attention)
from ray_tpu_torch.ops.fused_ce import fused_lm_head_ce
from ray_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention
# make_optimizer is re-exported: the JAX package defines it in this module.
from ray_tpu_torch.optim import AdamW, make_optimizer  # noqa: F401
from ray_tpu_torch.optim import make_step
from ray_tpu_torch.parallel.mesh import (DEFAULT_RULES, Mesh, axis_index,
                                         current_mesh, gather,
                                         logical_to_spec, partition)
from ray_tpu_torch.parallel.pipeline import pipeline_apply

Params = Dict[str, object]

_REMAT_POLICIES = ("save_attn", "save_attn_qkv", "save_attn_mlp",
                   "save_attn_qkv_mlp", "save_matmuls", "dots", "everything",
                   "full", "attn_outside")


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    #: Rematerialisation in the backward (``torch.utils.checkpoint``,
    #: non-reentrant). JAX names what its checkpoint saves; the port maps
    #: each policy to the nearest of three schedules:
    #:
    #: - ``remat=False``, and "save_matmuls", "dots", "everything" (save
    #:   every matmul input/output): nothing is checkpointed.
    #: - "full": each block is checkpointed whole, so the backward reruns
    #:   its forward, the splash kernel included.
    #: - "attn_outside" and "save_attn", "save_attn_qkv", "save_attn_mlp",
    #:   "save_attn_qkv_mlp": the block's two halves around attention
    #:   (``_block_pre_attn``, ``_block_post_attn``) are checkpointed
    #:   separately with ``SplashAttention`` between them, which keeps
    #:   (q, k, v, o, lse), so the splash forward never reruns. With
    #:   attn_impl="xla" the save_attn family checkpoints the whole block
    #:   instead (the plain attention would keep its (B, H, S, S) probs).
    #:   "save_attn_mlp", "save_attn_qkv_mlp" and ``save_mlp_act`` also keep
    #:   the post-half's MLP activation: the mlp_out product runs outside the
    #:   checkpoint.
    #:
    #: Remat never changes the numbers, only what is kept and what reruns.
    remat: bool = True
    remat_policy: str = "save_attn"
    attn_impl: str = "auto"  # auto | xla | pallas | splash | ring | ulysses
    #: GPipe stages over the mesh's ``pipe`` axis (``parallel/pipeline.py``)
    #: and their microbatches (0: one per stage).
    pp_stages: int = 1
    pp_microbatches: int = 0
    #: Sequence-chunked LM-head loss: logits and cross-entropy per chunk of
    #: this many positions, so the (B, S, V) logits are never whole. 0 = one
    #: unchunked product.
    loss_chunk: int = 0
    #: "auto" | "dense" | "fused". "fused" runs the fused LM-head
    #: cross-entropy kernels (``ops/fused_ce.py``); "auto" is dense (JAX
    #: flips it only on a TPU, and at D=768 keeps dense there too).
    loss_impl: str = "auto"
    #: Type the (B, S, V) logits of ``loss_fn`` materialise in; the
    #: logsumexp and the target gather still reduce in float32.
    logits_dtype: torch.dtype = torch.bfloat16
    #: ``scan_layers`` and ``scan_unroll`` choose between lax.scan and an
    #: unrolled loop in JAX; the port always runs the layers as a Python
    #: loop, so both are accepted and have no effect.
    scan_unroll: int = 1
    #: The TPU splash kernel's tile sizes; the Hopper kernels ignore them.
    attn_block_q: int = 512
    attn_block_kv: int = 512
    save_mlp_act: bool = False
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @staticmethod
    def small() -> "GPTConfig":
        return GPTConfig()  # 124M

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(vocab_size=1024, n_layer=2, n_head=4, d_model=128,
                         seq_len=128)


def init_params(config: GPTConfig, seed: int = 0,
                device: DeviceLike = None,
                place: Optional[Callable] = None) -> Params:
    """Random float32 parameters in the JAX package's layout and init scheme:
    normal(0.02) weights, wpe at 0.01, residual projections at
    0.02/sqrt(2L), zero biases, unit layernorm scales. Drawn on ``device``
    from a generator seeded with ``seed`` (the numbers differ from JAX's).
    ``place``, given, takes each leaf as it is drawn and gives what the
    tree keeps (``parallel.create_sharded_state`` keeps the rank's shard)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, L, V, S = config.d_model, config.n_layer, config.vocab_size, config.seq_len
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
            "mlp_in_w": norm((L, D, 4 * D), std),
            "mlp_in_b": const((L, 4 * D), 0.0),
            "mlp_out_w": norm((L, 4 * D, D), resid_std),
            "mlp_out_b": const((L, D), 0.0),
        },
        "lnf_scale": const((D,), 1.0),
        "lnf_bias": const((D,), 0.0),
    }


def logical_axes(config: GPTConfig) -> Dict[str, object]:
    """Logical-axis tree matching init_params (the reference's). The leading
    stacked-layer axis is "layers": sharded over ``pipe`` when pipelining,
    unsharded otherwise."""
    L = "layers"
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": {
            "ln1_scale": (L, "norm"),
            "ln1_bias": (L, "norm"),
            "qkv_w": (L, "embed", "heads"),
            "qkv_b": (L, "heads"),
            "out_w": (L, "heads", "embed"),
            "out_b": (L, "norm"),
            "ln2_scale": (L, "norm"),
            "ln2_bias": (L, "norm"),
            "mlp_in_w": (L, "embed", "mlp"),
            "mlp_in_b": (L, "mlp"),
            "mlp_out_w": (L, "mlp", "embed"),
            "mlp_out_b": (L, "norm"),
        },
        "lnf_scale": ("norm",),
        "lnf_bias": ("norm",),
    }


def num_params(config: GPTConfig) -> int:
    D, L, V, S = config.d_model, config.n_layer, config.vocab_size, config.seq_len
    per_block = 4 * D + 3 * D * D + 3 * D + D * D + D + 8 * D * D + 4 * D + D
    return V * D + S * D + L * per_block + 2 * D


def flops_per_token(config: GPTConfig) -> float:
    """6*P (fwd+bwd matmul) + attention score/value FLOPs (PaLM appendix B)."""
    return 6.0 * num_params(config) + 12.0 * config.n_layer * config.d_model * config.seq_len


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """float32 layernorm (population variance); returns float32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale + bias


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of (B, S, ..., K) activations and a (K, N) weight. With the
    sequence sharded over a ``seq`` axis that spans ranks and the weight
    replicated, each rank multiplies its own rows under ``shard_map``:
    DTensor's matmul first flattens (B, S), which torch 2.11 refuses with
    both dimensions sharded (its gradient of ``w`` is then the sum over the
    shards that ``shard_map`` places)."""
    if is_dtensor(x) and is_dtensor(w) and "seq" in Mesh.of(x).dim_names \
            and all(p.is_replicate() for p in w.placements):
        spec = logical_to_spec(("batch", "seqlen") + (None,) * (x.ndim - 2))
        return shard_map(torch.matmul, mesh=Mesh.of(x),
                         in_specs=(spec, partition()), out_specs=spec)(x, w)
    return x @ w


#: The layout of q, k, v and the attention output, (B, S, H, hd), on a mesh.
_QKV_AXES = ("batch", "seqlen", "heads", "kv")
#: The same with the whole sequence on each rank: what attention that is not
#: context-parallel takes.
_QKV_WHOLE_SEQ = ("batch", None, "heads", "kv")


def _qkv_spec(config) -> tuple:
    """The PartitionSpec a rank's q, k, v take on a mesh: the sequence
    sharded over ``seq`` for the context-parallel paths (ring, Ulysses),
    whole for the others."""
    cp = config.attn_impl in ("ring", "ulysses")
    return logical_to_spec(_QKV_AXES if cp else _QKV_WHOLE_SEQ)


def _seq_offset(mesh: Mesh, spec, seq_len: int) -> int:
    """The global position of a rank's first row along a (B, S, ...) tensor
    placed by ``spec`` on ``mesh``: its ``seq`` index times the shard's
    length when ``spec`` shards the sequence over ``seq``, else 0."""
    if len(spec) < 2 or spec[1] != "seq":
        return 0
    return axis_index(mesh, "seq") * (seq_len // mesh.shape["seq"])


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               config: GPTConfig, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """Causal multi-head attention, q, k, v: (B, S, H, hd).

    auto/splash run the splash kernel, pallas runs it through
    ``flash_attention`` (the same kernel), xla runs the plain version.
    ring/ulysses are the context-parallel paths (``ops/ring_attention.py``)
    over the ``seq`` axis of ``mesh`` or of the ambient mesh: callers install
    it with ``ray_tpu_torch.parallel.use_mesh`` or ``jit_train_step(mesh=)``.
    DTensors on a device mesh (``parallel.make_mesh``) go through
    ``shard_map``: each rank attends over its batch shard and its heads, and
    over its sequence shard on the context-parallel paths (the whole
    sequence, gathered, on the others).
    """
    impl = config.attn_impl
    if impl not in ("auto", "xla", "pallas", "splash", "ring", "ulysses"):
        raise ValueError(
            f"Unknown attn_impl: {impl!r} "
            "(use auto|xla|pallas|splash|ring|ulysses)")
    if is_dtensor(q):
        mesh = Mesh.of(q)
        spec = _qkv_spec(config)
        return shard_map(partial(_attention, config=config, mesh=mesh),
                         mesh=mesh, in_specs=(spec,) * 3,
                         out_specs=spec)(q, k, v)
    if impl in ("auto", "splash"):
        return splash_attention(q, k, v, causal=True,
                                block_q=config.attn_block_q,
                                block_kv=config.attn_block_kv)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=True)
    if impl == "ring":
        return ring_attention(q, k, v, causal=True, mesh=mesh)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, causal=True, mesh=mesh)
    return attention_reference(q, k, v, causal=True)[0]


def _block_pre_attn(x: torch.Tensor, blk: Params, config: GPTConfig
                    ) -> torch.Tensor:
    """ln1 + qkv projection (the part before attention)."""
    dt = config.dtype
    h = _layernorm(x, blk["ln1_scale"], blk["ln1_bias"]).to(dt)
    return _mm(h, blk["qkv_w"].to(dt)) + blk["qkv_b"].to(dt)


def _post_attn_mlp_in(x: torch.Tensor, attn: torch.Tensor, blk: Params,
                      config: GPTConfig):
    """Residual out-projection, ln2, mlp_in and GELU: (x, MLP activation)."""
    dt = config.dtype
    x = x + _mm(attn, blk["out_w"].to(dt)) + blk["out_b"].to(dt)
    h = _layernorm(x, blk["ln2_scale"], blk["ln2_bias"]).to(dt)
    return x, F.gelu(_mm(h, blk["mlp_in_w"].to(dt)) + blk["mlp_in_b"].to(dt),
                     approximate="tanh")


def _post_attn_mlp_out(x: torch.Tensor, act: torch.Tensor, blk: Params,
                       config: GPTConfig) -> torch.Tensor:
    dt = config.dtype
    return x + _mm(act, blk["mlp_out_w"].to(dt)) + blk["mlp_out_b"].to(dt)


def _block_post_attn(x: torch.Tensor, attn: torch.Tensor, blk: Params,
                     config: GPTConfig) -> torch.Tensor:
    """Residual out-projection + MLP (the part after attention)."""
    x, act = _post_attn_mlp_in(x, attn, blk, config)
    return _post_attn_mlp_out(x, act, blk, config)


def _attend(qkv: torch.Tensor, config: GPTConfig) -> torch.Tensor:
    B, S, D3 = qkv.shape
    D, H, hd = D3 // 3, config.n_head, config.head_dim
    # Views into qkv with a row stride of 3*D; the kernel takes them as is.
    q, k, v = (t.view(B, S, H, hd) for t in qkv.split(D, dim=-1))
    return _attention(q, k, v, config).reshape(B, S, D)


def _block(x: torch.Tensor, blk: Params, config: GPTConfig) -> torch.Tensor:
    qkv = _block_pre_attn(x, blk, config)
    return _block_post_attn(x, _attend(qkv, config), blk, config)


_ckpt = partial(checkpoint, use_reentrant=False, preserve_rng_state=False)


def _block_split(x: torch.Tensor, blk: Params, config: GPTConfig,
                 keep_mlp_act: bool) -> torch.Tensor:
    """The block with its two halves checkpointed separately and attention
    (which keeps its own q, k, v, o, lse) between them
    (``ray_tpu/models/gpt2.py:276-328``)."""
    qkv = _ckpt(_block_pre_attn, x, blk, config)
    attn = _attend(qkv, config)
    if not keep_mlp_act:
        return _ckpt(_block_post_attn, x, attn, blk, config)
    x, act = _ckpt(_post_attn_mlp_in, x, attn, blk, config)
    return _post_attn_mlp_out(x, act, blk, config)


def block_fn(config: GPTConfig) -> Callable[[torch.Tensor, Params],
                                            torch.Tensor]:
    """One transformer block under the config's remat schedule (see
    ``GPTConfig.remat``)."""
    policy = config.remat_policy
    if not config.remat or policy in ("save_matmuls", "dots", "everything"):
        return partial(_block, config=config)
    if policy == "full" or config.attn_impl == "xla":
        return lambda x, blk: _ckpt(_block, x, blk, config)
    keep = config.save_mlp_act or policy in ("save_attn_mlp",
                                             "save_attn_qkv_mlp")
    return partial(_block_split, config=config, keep_mlp_act=keep)


def _validate(config: GPTConfig) -> None:
    """The JAX forward's configuration errors, raised at the same call."""
    if config.save_mlp_act and config.remat_policy != "attn_outside":
        raise ValueError(
            "save_mlp_act applies only to remat_policy='attn_outside' "
            "(use remat_policy='save_attn_mlp' with the scan path)")
    if config.remat and config.remat_policy == "attn_outside" \
            and config.attn_impl == "xla":
        raise ValueError(
            "remat_policy='attn_outside' with attn_impl='xla' would "
            "materialize per-layer (B, H, S, S) probs as saved "
            "residuals; use a flash-style attn_impl or save_attn")
    if config.remat and config.remat_policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {config.remat_policy!r} "
            f"(use {sorted(_REMAT_POLICIES)})")
    if config.pp_stages > 1 and config.remat \
            and config.remat_policy == "attn_outside":
        raise ValueError(
            "remat_policy='attn_outside' does not compose with "
            "pp_stages>1 yet; use save_attn")


def _embed(wte: torch.Tensor, wpe: Optional[torch.Tensor],
           tokens: torch.Tensor, dtype: torch.dtype,
           offset: int = 0) -> torch.Tensor:
    """Token (plus, given ``wpe``, position) embeddings, (B, S, D) in
    ``dtype``; ``offset`` is the global position of the first column. On a
    device mesh each rank looks up its batch and sequence shard in the
    whole tables (gathered; their gradients come back summed over the
    shards), at the global positions of its shard."""
    if is_dtensor(tokens):
        tables = (wte,) if wpe is None else (wte, wpe)
        mesh = Mesh.of(tokens)
        spec = logical_to_spec(("batch", "seqlen"))
        start = _seq_offset(mesh, spec, tokens.shape[1])
        return shard_map(
            lambda tokens, wte, wpe=None: _embed(wte, wpe, tokens, dtype,
                                                 start),
            mesh=mesh, in_specs=(spec,) + (partition(),) * len(tables),
            out_specs=logical_to_spec(("batch", "seqlen", None)))(
                tokens, *tables)
    x = wte[tokens].to(dtype)
    if wpe is None:
        return x
    return x + wpe[offset:offset + tokens.shape[1]].to(dtype)


def sharded_mean(mean_fn: Callable, x: torch.Tensor, targets: torch.Tensor,
                 *weights: torch.Tensor) -> torch.Tensor:
    """``mean_fn(x, targets, *weights)``, a mean over the targets: the
    leading (batch) rows of x and, for (B, S) targets, its sequence too. On
    a device mesh each rank runs it over its batch (and ``seq``) shard with
    the whole (gathered) weights, weighted by its share of the targets, and
    the global mean is the sum of those terms over the shards."""
    if not is_dtensor(x):
        return mean_fn(x, targets, *weights)
    lead = ("batch", "seqlen")[:min(targets.ndim, 2)]
    total = targets.numel()

    def local(x, targets, *weights):
        return mean_fn(x, targets, *weights) * (targets.numel() / total)

    def spec(t):
        return logical_to_spec(lead + (None,) * (t.ndim - len(lead)))

    summed = DEFAULT_RULES["batch"] + (DEFAULT_RULES["seqlen"]
                                       if len(lead) > 1 else ())
    return shard_map(local, mesh=Mesh.of(x),
                     in_specs=(spec(x), spec(targets))
                     + (partition(),) * len(weights),
                     out_specs=Pending(partition(), summed))(
                         x, targets, *weights)


def forward_hidden(params: Params, tokens: torch.Tensor,
                   config: GPTConfig) -> torch.Tensor:
    """tokens (B, S) int -> final-layernormed hidden states (B, S, D)."""
    _validate(config)
    dt = config.dtype
    x = _embed(params["wte"], params["wpe"], tokens, dt)
    blocks = params["blocks"]
    # Checkpointing only matters when a backward will run.
    block = (block_fn(config) if torch.is_grad_enabled()
             else partial(_block, config=config))

    def stack(local_blocks, h):
        for i in range(next(iter(local_blocks.values())).shape[0]):
            h = block(h, gather({n: w[i] for n, w in local_blocks.items()}))
        return h

    if config.pp_stages > 1:
        x = _pipelined(stack, blocks, x, config)
    else:
        x = stack(blocks, x)
    return _layernorm(x, params["lnf_scale"], params["lnf_bias"]).to(dt)


def stage_hidden(params: Params, x: torch.Tensor, config: GPTConfig, *,
                 first: bool, last: bool) -> torch.Tensor:
    """One stage of an inference forward split by layers over devices or
    actors, over the blocks in ``params["blocks"]`` (a span of the stack):
    the first stage takes (B, S) token ids and embeds them, the last ends
    with the final layernorm. A stage that is both is ``forward_hidden``
    without remat, in the same operations, so a split forward gives the
    whole one's numbers."""
    dt = config.dtype
    if first:
        x = _embed(params["wte"], params["wpe"], x, dt)
    blocks = params["blocks"]
    for i in range(next(iter(blocks.values())).shape[0]):
        x = _block(x, gather({n: w[i] for n, w in blocks.items()}), config)
    if last:
        x = _layernorm(x, params["lnf_scale"], params["lnf_bias"]).to(dt)
    return x


def _pipelined(stack: Callable, blocks: Params, x: torch.Tensor,
               config: GPTConfig) -> torch.Tensor:
    """The block stack as a GPipe schedule over the mesh's ``pipe`` axis,
    each stage running its local slice of the stacked blocks
    (``ray_tpu/models/gpt2.py:372-397``), with the reference's checks."""
    if config.n_layer % config.pp_stages:
        raise ValueError(
            f"n_layer {config.n_layer} % pp_stages {config.pp_stages} != 0")
    # The mesh is authoritative for the stage count: a mismatched config
    # would silently run a different schedule than requested.
    mesh = Mesh.of(x) if is_dtensor(x) else current_mesh()
    if mesh is not None and mesh.shape["pipe"] not in (1, config.pp_stages):
        raise ValueError(
            f"config.pp_stages={config.pp_stages} but mesh pipe axis is "
            f"{mesh.shape['pipe']}")
    return pipeline_apply(
        stack, blocks, x,
        n_microbatches=config.pp_microbatches or config.pp_stages)


def lm_head(x: torch.Tensor, wte: torch.Tensor, out_dtype: torch.dtype
            ) -> torch.Tensor:
    """Tied LM head x @ wte^T with the product in ``out_dtype``.

    For a wider ``out_dtype`` than the operands (float32 logits from bf16
    activations, as JAX's ``preferred_element_type``) the bf16 operands are
    upcast: every product of two bf16 values is exact in float32, so with
    TF32 off this is a float32-accumulated bf16 product, at float32 matmul
    speed.
    """
    if x.dtype == out_dtype:
        return _mm(x, wte.to(x.dtype).t())
    return _mm(x.to(out_dtype), wte.to(x.dtype).to(out_dtype).t())


def forward(params: Params, tokens: torch.Tensor, config: GPTConfig
            ) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32."""
    x = forward_hidden(params, tokens, config)
    return lm_head(x, params["wte"], torch.float32)


def _ce_sum(x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
            logits_dtype: torch.dtype) -> torch.Tensor:
    logits = lm_head(x, wte, logits_dtype)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0].float()
    return (lse - tgt).sum()


def _head_loss(x: torch.Tensor, targets: torch.Tensor, wte: torch.Tensor,
               config: GPTConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the final hidden states x (B, S, D):
    the fused LM-head kernels, or a dense or sequence-chunked head."""
    B, S, D = x.shape
    if config.loss_impl == "fused":
        return fused_lm_head_ce(x, wte, targets)
    C = config.loss_chunk
    if not C or C >= S:
        return _ce_sum(x, wte, targets, config.logits_dtype) / (B * S)
    if S % C:
        raise ValueError(f"loss_chunk {C} must divide seq_len {S}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, C):
        total = total + _ce_sum(x[:, c0:c0 + C], wte, targets[:, c0:c0 + C],
                                config.logits_dtype)
    return total / (B * S)


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            config: GPTConfig) -> torch.Tensor:
    """Mean next-token cross-entropy: the fused LM-head kernels, or a dense
    or sequence-chunked head (``sharded_mean`` on a device mesh; a
    vocab-parallel head is ROADMAP Queue 2 work)."""
    if config.loss_impl not in ("auto", "fused", "dense"):
        raise ValueError(
            f"loss_impl must be auto|fused|dense, got {config.loss_impl!r}")
    x = forward_hidden(params, tokens, config)
    return sharded_mean(partial(_head_loss, config=config), x, targets,
                        params["wte"])


def inference_params(params: Params, config: GPTConfig) -> Params:
    """The parameters with every matmul and embedding weight cast once to
    ``config.dtype``; layernorm parameters stay float32. ``forward`` gives
    the same numbers from either, since it casts the same weights itself,
    but a server then reads half the bytes on every request."""
    def cast(name, w):
        return w if name.startswith("ln") else w.to(config.dtype)

    out = {n: cast(n, w) for n, w in params.items() if n != "blocks"}
    out["blocks"] = {n: cast(n, w) for n, w in params["blocks"].items()}
    return out


def make_train_step(config: GPTConfig, optimizer: AdamW):
    """(params, opt_state, tokens, targets) -> (params, opt_state, loss):
    ``optim.make_step`` over ``loss_fn`` (parameters updated in place, the
    loss detached on the device)."""
    return make_step(partial(loss_fn, config=config), optimizer)


def make_eval_step(config: GPTConfig):
    """(params, tokens, targets) -> mean loss, without a graph."""
    def step(params: Params, tokens: torch.Tensor, targets: torch.Tensor):
        with torch.no_grad():
            return loss_fn(params, tokens, targets, config)

    return step
