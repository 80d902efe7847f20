"""Context parallelism, ring attention and Ulysses: the port of
``ray_tpu/ops/ring_attention.py``.

The JAX package runs both under ``shard_map`` over the mesh's ``seq`` axis:
each of W devices holds one sequence shard, and K/V chunks rotate around the
ring with ``lax.ppermute`` (ring) or heads and sequence trade places with
``lax.all_to_all`` (Ulysses). The port runs the ``seq`` axis two ways
(``ray_tpu_torch/parallel/mesh.py``):

- across process ranks, when the mesh's ``seq`` axis spans the process
  group: each rank holds its (B, S/W, H, hd) shard, as in JAX. K/V chunks
  move one rank on per step through ``_private/torch_compat.py``'s shift
  (staged through host memory over gloo, direct over NCCL) and Ulysses'
  reshards are its ``all_to_all``. ``ring_forward_shard`` and
  ``ring_backward_shard`` launch one kernel per rank per ring step on the
  rank's own shard (``ring_fwd_block``, ``ring_bwd_block``), with the next
  chunk's shift posted before the launch and waited on after it; dk and dv
  ride the ring with their chunk and land home after W shifts (JAX's
  ``_fused_ring_bwd``, :242-312);
- folded onto one device, for a ``seq``-only mesh in a process that joined
  no process group of its size: the tensors are the whole (B, S, H, hd)
  sequence, rank r's shard being rows r*S/W .. (r+1)*S/W - 1, and each ring
  step is one launch over every rank that computes at it. ``ring_source``
  is then the whole rotation and ``_seq_to_heads``/``_heads_to_seq`` the
  whole all-to-all.

What is the ring's own either way: the per-step kernels, the streaming
merge, the causal skip and the gradient flow; the two give the same tiles
in the same order, so the same numbers.

- ``ring_attention_local(impl="einsum")``: the streaming log-sum-exp body in
  plain PyTorch, vectorised over the ranks (per rank, with ``ppermute``,
  across processes), differentiated by autograd.
- ``impl="fused"``: ``FusedRing``, a ``torch.autograd.Function`` (JAX's
  ``_fused_ring_core`` custom VJP). On CUDA tensors each ring step is one
  launch of the hand-written Hopper kernel ``csrc/ring_attention_fwd.cu``
  (attention of every computing rank's queries to its chunk, merged into the
  fp32 running output in the kernel), and each backward step one launch of
  ``csrc/ring_attention_bwd.cu`` (dq, dk, dv added into fp32 accumulators
  from the global lse and delta). Step 0 writes the accumulators instead of
  merging or adding, so they start uninitialised. On CPU tensors the same
  steps run the plain versions ``ring_fwd_step_reference`` and
  ``ring_bwd_step_reference``. A CUDA tensor goes through the kernels or
  raises.
- ``impl="auto"`` picks fused when ``_ring_block(S / W)`` is a legal splash
  block, as JAX does. JAX also probes its private splash surfaces
  (``_fused_available``, ``_probe_fused_surfaces``) and downgrades to einsum
  when a JAX upgrade breaks them; the port's kernels are its own, so it has
  no such probe. ``_mark_varying`` (shard_map plumbing) and
  ``_head_pad_target`` (the 128-lane TPU head padding) have no counterpart
  either: the kernels take head_dim 64 and 128 as they are.

``LAUNCHES`` counts the kernels' launches (one per ring step and wrapper
call), so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch._private import kernel_build
from ray_tpu_torch._private import torch_compat
from ray_tpu_torch.ops.attention import (_check, _kernel_inputs,
                                         attention_bwd_reference,
                                         attention_reference)
from ray_tpu_torch.parallel.mesh import (Mesh, MeshLike, PartitionSpec,
                                         axis_index, current_mesh, make_mesh)

_NEG = -1e30  # strictly-finite mask value: -inf breaks the streaming max

#: Launches per kernel since the last reset; only a kernel launch adds one.
LAUNCHES: Dict[str, int] = {"ring_attention_fwd": 0, "ring_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ring_block(seq_len: int) -> Optional[int]:
    """Largest multiple-of-128 divisor of seq_len, capped at 512: the JAX
    package's legal splash block, which decides ``impl="auto"`` there and
    here (the Hopper kernels themselves take any length)."""
    for b in (512, 384, 256, 128):
        if b <= seq_len and seq_len % b == 0:
            return b
    return None


# ------------------------------------------------------------- the rotation
def ring_source(step: int, rank: int, world: int) -> int:
    """The chunk rank ``rank`` holds at ring step ``step``: K/V move one rank
    on (i -> i + 1) per step, so it is the chunk of rank (rank - step) mod W
    (``ray_tpu/ops/ring_attention.py:398``)."""
    return (rank - step) % world


def ring_pairs(step: int, world: int, causal: bool) -> List[Tuple[int, int]]:
    """(rank, chunk) of every rank that computes at ``step``. Under the causal
    mask a rank whose chunk lies after its own shard skips: no launch covers
    it, as ``lax.switch`` skips at :225-229."""
    pairs = [(r, ring_source(step, r, world)) for r in range(world)]
    return [(r, c) for r, c in pairs if not causal or c <= r]


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _rows(index: int, shard: int) -> slice:
    return slice(index * shard, (index + 1) * shard)


# --------------------------------------------------------- plain versions
def ring_fwd_step_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o_acc: Optional[torch.Tensor],
                            lse_acc: Optional[torch.Tensor], causal: bool,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one (rank, chunk) block of the forward kernel.

    q (B, S, H, hd) is the rank's shard, k and v the chunk's; o_acc
    (B, S, H, hd) and lse_acc (B, H, S) fp32 the rank's running output and
    lse. Returns the merged (o_acc, lse_acc) (``ring_attention.py:232-234``),
    or, with o_acc and lse_acc None (the ring's first step), the block's own
    (o, lse): what the merge gives from o = 0, lse = -1e30, bit for bit.
    ``causal`` is the diagonal mask. The block's o comes out of
    ``attention_reference`` in q's type, as JAX's splash output does.
    """
    o_b, lse_b = attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if o_acc is None:
        return o_b.float(), lse_b
    lse_new = torch.logaddexp(lse_acc, lse_b)
    w_old = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o_acc * w_old + o_b.float() * w_new, lse_new


def ring_bwd_step_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: Optional[torch.Tensor],
                            lse: torch.Tensor, do: torch.Tensor,
                            delta: torch.Tensor,
                            dq_acc: Optional[torch.Tensor],
                            dk_acc: Optional[torch.Tensor],
                            dv_acc: Optional[torch.Tensor],
                            causal: bool, sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of one (rank, chunk) block of the backward kernel.

    q, do, lse (B, H, S) and delta (B, H, S) are the rank's (lse and delta
    the global ones of the merged forward), k and v the chunk's. Returns
    (dq_acc, dk_acc, dv_acc) plus the block's gradients, each rounded to its
    input's type first, as JAX's splash backward output is (:282); with the
    accumulators None (the ring's first step), the block's gradients alone.
    ``o`` is not read: delta is given.
    """
    dq, dk, dv = attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm_scale, delta=delta)
    if dq_acc is None:
        return dq.float(), dk.float(), dv.float()
    return dq_acc + dq.float(), dk_acc + dk.float(), dv_acc + dv.float()


def ring_fwd_step_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o_acc: torch.Tensor, lse_acc: torch.Tensor, *,
                        step: int, world: int, causal: bool = True,
                        sm_scale: Optional[float] = None) -> None:
    """Plain version of ``ring_fwd_step`` on any device:
    ``ring_fwd_step_reference`` for each rank that computes at ``step``;
    step 0 writes every rank's rows and reads none."""
    shard, scale = q.shape[1] // world, _scale(q, sm_scale)
    first = step == 0
    for r, c in ring_pairs(step, world, causal):
        rs, cs = _rows(r, shard), _rows(c, shard)
        o_acc[:, rs], lse_acc[:, :, rs] = ring_fwd_step_reference(
            q[:, rs], k[:, cs], v[:, cs], None if first else o_acc[:, rs],
            None if first else lse_acc[:, :, rs], causal and first, scale)


def ring_bwd_step_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, dq_acc: torch.Tensor,
                        dk_acc: torch.Tensor, dv_acc: torch.Tensor, *,
                        step: int, world: int, causal: bool = True,
                        sm_scale: Optional[float] = None) -> None:
    """Plain version of ``ring_bwd_step`` on any device:
    ``ring_bwd_step_reference`` for each rank that computes at ``step``;
    step 0 writes every row of dq, dk, dv and reads none."""
    shard, scale = q.shape[1] // world, _scale(q, sm_scale)
    first = step == 0
    for r, c in ring_pairs(step, world, causal):
        rs, cs = _rows(r, shard), _rows(c, shard)
        accs = ((None,) * 3 if first
                else (dq_acc[:, rs], dk_acc[:, cs], dv_acc[:, cs]))
        dq_acc[:, rs], dk_acc[:, cs], dv_acc[:, cs] = ring_bwd_step_reference(
            q[:, rs], k[:, cs], v[:, cs], None, lse[:, :, rs], do[:, rs],
            delta[:, :, rs], *accs, causal and first, scale)


# --------------------------------------------------------- kernel wrappers
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_tables_lock = threading.Lock()
_tables: Dict[Tuple[int, bool, torch.device], torch.Tensor] = {}


def _pair_table(world: int, causal: bool, device: torch.device) -> torch.Tensor:
    """(W, W, 2) int32 on ``device``: row s holds ``ring_pairs(s)``, padded.
    Built once per (W, mask, device), so a launch copies nothing to the
    device (and a CUDA graph can capture it)."""
    key = (world, causal, device)
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            host = torch.zeros((world, world, 2), dtype=torch.int32)
            for s in range(world):
                for i, pair in enumerate(ring_pairs(s, world, causal)):
                    host[s, i] = torch.tensor(pair, dtype=torch.int32)
            table = _tables[key] = host.to(device)
        return table


def _accumulator(x: torch.Tensor, shape, name: str) -> None:
    """The kernels move accumulator rows with the bulk copy engine, which
    takes 16-byte aligned addresses."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned float32 "
            f"{tuple(shape)} tensor, got {x.dtype} {tuple(x.shape)} "
            f"(contiguous={x.is_contiguous()}, address {x.data_ptr():#x})")


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _ring_args(q: torch.Tensor, world: int, causal: bool, step: int):
    """Checks the ring layout and returns (pointer to the step's pairs, their
    count, rows of one shard)."""
    S = q.shape[1]
    if S % world:
        raise ValueError(f"sequence length {S} not divisible by W={world}")
    if not 0 <= step < world:
        raise ValueError(f"step {step} outside the ring of {world}")
    table = _pair_table(world, causal, q.device)
    ptr = table.data_ptr() + step * world * 2 * table.element_size()
    return ptr, len(ring_pairs(step, world, causal)), S // world


def _ring_fwd_cuda(q, k, v, o_acc, lse_acc, step, world, causal, scale):
    pairs, n, shard = _ring_args(q, world, causal, step)
    _fwd_launch(q, k, v, o_acc, lse_acc, pairs, n, world, shard,
                causal and step == 0, step == 0, scale)


def _fwd_launch(q, k, v, o_acc, lse_acc, pairs, n, world, shard, diagonal,
                first, scale):
    q, k, v = _kernel_inputs({"q": q, "k": k, "v": v})
    B, S, H, hd = q.shape
    _accumulator(o_acc, (B, S, H, hd), "o_acc")
    _accumulator(lse_acc, (B, H, S), "lse_acc")
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_acc.data_ptr(),
                 lse_acc.data_ptr(), pairs, n, world, B, shard, H, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale,
                 int(diagonal), int(first), stream)
    _launch("ring_attention_fwd", err)


def _ring_bwd_cuda(q, k, v, do, lse, delta, dq, dk, dv, step, world, causal,
                   scale):
    pairs, n, shard = _ring_args(q, world, causal, step)
    _bwd_launch(q, k, v, do, lse, delta, dq, dk, dv, pairs, n, world, shard,
                causal and step == 0, step == 0, scale)


def _bwd_launch(q, k, v, do, lse, delta, dq, dk, dv, pairs, n, world, shard,
                diagonal, first, scale):
    q, k, v, do = _kernel_inputs({"q": q, "k": k, "v": v, "do": do})
    B, S, H, hd = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        _accumulator(x, (B, H, S), name)
    for name, x in (("dq_acc", dq), ("dk_acc", dk), ("dv_acc", dv)):
        _accumulator(x, (B, S, H, hd), name)
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), pairs, n, world, B, shard, H,
                 hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *do.stride()[:3], scale, int(diagonal), int(first), stream)
    _launch("ring_attention_bwd", err)


def _fwd_fn():
    fn = kernel_build.load("ring_attention_fwd").ring_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * 6 + [_I32] * 6 + [_I64] * 9
                       + [ctypes.c_float, _I32, _I32, _PTR])
        fn.restype = _I32
    return fn


def _bwd_fn():
    fn = kernel_build.load("ring_attention_bwd").ring_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * 10 + [_I32] * 6 + [_I64] * 12
                       + [ctypes.c_float, _I32, _I32, _PTR])
        fn.restype = _I32
    return fn


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def ring_fwd_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o_acc: torch.Tensor, lse_acc: torch.Tensor, *, step: int,
                  world: int, causal: bool = True,
                  sm_scale: Optional[float] = None) -> None:
    """Ring step ``step`` of the forward for every rank that computes at it,
    merged into o_acc (B, S, H, hd) and lse_acc (B, H, S), fp32, in place.
    Step 0 (every rank's own chunk) writes both and reads neither, so they
    may start uninitialised.

    q, k, v: the whole (B, S, H, hd) sequence of W = ``world`` shards. CUDA
    tensors (bfloat16, head_dim 64 or 128) run one launch of the Hopper
    kernel; CPU tensors run ``ring_fwd_step_plain``.
    """
    if _device_kind(q) == "cuda":
        _ring_fwd_cuda(q, k, v, o_acc, lse_acc, step, world, causal,
                       _scale(q, sm_scale))
    else:
        ring_fwd_step_plain(q, k, v, o_acc, lse_acc, step=step, world=world,
                            causal=causal, sm_scale=sm_scale)


def ring_bwd_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  dq_acc: torch.Tensor, dk_acc: torch.Tensor,
                  dv_acc: torch.Tensor, *, step: int, world: int,
                  causal: bool = True,
                  sm_scale: Optional[float] = None) -> None:
    """Ring step ``step`` of the backward: every computing rank's dq, and the
    dk, dv of the chunk it holds, added in place into the fp32 (B, S, H, hd)
    accumulators, from the forward's global lse and delta (B, H, S). Step 0
    writes every row of the three and reads none.

    CUDA tensors run one launch of the Hopper kernel (its dk/dv and dq
    passes); CPU tensors run ``ring_bwd_step_plain``.
    """
    if _device_kind(q) == "cuda":
        _ring_bwd_cuda(q, k, v, do, lse, delta, dq_acc, dk_acc, dv_acc, step,
                       world, causal, _scale(q, sm_scale))
    else:
        ring_bwd_step_plain(q, k, v, do, lse, delta, dq_acc, dk_acc, dv_acc,
                            step=step, world=world, causal=causal,
                            sm_scale=sm_scale)


def ring_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 world: int, causal: bool = True,
                 sm_scale: Optional[float] = None, plain: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W ring steps of the forward: the merged fp32 output (B, S, H, hd)
    and lse (B, H, S). Step 0 writes both (what merging into o = 0,
    lse = -1e30 would give), so they start uninitialised. ``plain`` runs the
    plain step on any device (what the kernel is held against on the card)."""
    B, S, H, hd = q.shape
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    step_fn = ring_fwd_step_plain if plain else ring_fwd_step
    for step in range(world):
        step_fn(q, k, v, o, lse, step=step, world=world, causal=causal,
                sm_scale=sm_scale)
    return o, lse


def ring_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(o * do) of the fp32 merged o, (B, H, S) (``:258``)."""
    return (o * do.float()).sum(-1).transpose(1, 2).contiguous()


def ring_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  world: int, causal: bool = True,
                  sm_scale: Optional[float] = None, plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The W ring steps of the backward: fp32 (dq, dk, dv), each
    (B, S, H, hd), from the merged fp32 o and lse of ``ring_forward``.
    Step 0 writes every row, so the accumulators start uninitialised.
    ``plain`` runs the plain step on any device."""
    delta = ring_delta(o, do)
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    step_fn = ring_bwd_step_plain if plain else ring_bwd_step
    for step in range(world):
        step_fn(q, k, v, do, lse, delta, dq, dk, dv, step=step, world=world,
                causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


class FusedRing(torch.autograd.Function):
    """Ring attention with the kernels' own gradient (JAX's
    ``_fused_ring_core``): the forward runs ``ring_forward`` and saves
    (q, k, v, fp32 o, lse); the backward runs ``ring_backward`` on them, so
    no recompute of the forward is needed under any remat schedule."""

    @staticmethod
    def forward(ctx, q, k, v, world: int, causal: bool, scale: float):
        o, lse = ring_forward(q, k, v, world=world, causal=causal,
                              sm_scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.world, ctx.causal, ctx.scale = world, causal, scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, o, lse, do.to(q.dtype),
                                   world=ctx.world, causal=ctx.causal,
                                   sm_scale=ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


# -------------------------------------------------- the ring across ranks
def ring_fwd_block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o_acc: torch.Tensor, lse_acc: torch.Tensor, *,
                         diagonal: bool, first: bool,
                         sm_scale: Optional[float] = None) -> None:
    """Plain version of ``ring_fwd_block`` on any device:
    ``ring_fwd_step_reference`` of the rank's shard and the chunk it holds,
    written into (``first``) or merged into o_acc and lse_acc in place."""
    o, lse = ring_fwd_step_reference(q, k, v, None if first else o_acc,
                                     None if first else lse_acc, diagonal,
                                     _scale(q, sm_scale))
    o_acc.copy_(o)
    lse_acc.copy_(lse)


def ring_bwd_block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor,
                         delta: torch.Tensor, dq_acc: torch.Tensor,
                         dk_acc: torch.Tensor, dv_acc: torch.Tensor, *,
                         diagonal: bool, first: bool,
                         sm_scale: Optional[float] = None) -> None:
    """Plain version of ``ring_bwd_block`` on any device:
    ``ring_bwd_step_reference`` of the rank's shard and the chunk it holds,
    written into (``first``) or added into dq, dk, dv in place."""
    accs = (None,) * 3 if first else (dq_acc, dk_acc, dv_acc)
    dq, dk, dv = ring_bwd_step_reference(q, k, v, None, lse, do, delta,
                                         *accs, diagonal,
                                         _scale(q, sm_scale))
    dq_acc.copy_(dq)
    dk_acc.copy_(dk)
    dv_acc.copy_(dv)


def ring_fwd_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o_acc: torch.Tensor, lse_acc: torch.Tensor, *,
                   diagonal: bool, first: bool,
                   sm_scale: Optional[float] = None) -> None:
    """One rank's ring step of the forward, on its own shard: q (B, S, H,
    hd) the rank's shard, k and v the chunk it holds; merged into its fp32
    o_acc (B, S, H, hd) and lse_acc (B, H, S) in place, or written when
    ``first`` (the ring's step 0, which reads neither). ``diagonal`` is the
    causal mask of the step where the rank holds its own chunk.

    CUDA tensors run one launch of ``csrc/ring_attention_fwd.cu`` with the
    single pair (0, 0) and W = 1: the tiles of that rank's pair in the
    folded launch. CPU tensors run ``ring_fwd_block_plain``."""
    if _device_kind(q) == "cuda":
        _fwd_launch(q, k, v, o_acc, lse_acc,
                    _pair_table(1, False, q.device).data_ptr(), 1, 1,
                    q.shape[1], diagonal, first, _scale(q, sm_scale))
    else:
        ring_fwd_block_plain(q, k, v, o_acc, lse_acc, diagonal=diagonal,
                             first=first, sm_scale=sm_scale)


def ring_bwd_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   dq_acc: torch.Tensor, dk_acc: torch.Tensor,
                   dv_acc: torch.Tensor, *, diagonal: bool, first: bool,
                   sm_scale: Optional[float] = None) -> None:
    """One rank's ring step of the backward, on its own shard: the rank's
    dq, and the dk, dv of the chunk it holds, added into fp32 (B, S, H, hd)
    accumulators in place (written when ``first``) from the global lse and
    delta (B, H, S) of the rank's rows. CUDA tensors run one launch of
    ``csrc/ring_attention_bwd.cu`` with the pair (0, 0) and W = 1; CPU
    tensors run ``ring_bwd_block_plain``."""
    if _device_kind(q) == "cuda":
        _bwd_launch(q, k, v, do, lse, delta, dq_acc, dk_acc, dv_acc,
                    _pair_table(1, False, q.device).data_ptr(), 1, 1,
                    q.shape[1], diagonal, first, _scale(q, sm_scale))
    else:
        ring_bwd_block_plain(q, k, v, do, lse, delta, dq_acc, dk_acc, dv_acc,
                             diagonal=diagonal, first=first,
                             sm_scale=sm_scale)


def _ring_perm(world: int) -> List[Tuple[int, int]]:
    return [(i, (i + 1) % world) for i in range(world)]


def _computes(chunk: int, rank: int, causal: bool) -> bool:
    """A chunk after the rank's own shard is masked out whole: no launch
    (``lax.switch``'s skip at :225-229)."""
    return not causal or chunk <= rank


def ring_forward_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, group, causal: bool = True,
                       sm_scale: Optional[float] = None, plain: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W ring steps of the forward on this rank's (B, S/W, H, hd) shard
    of a ring over the process ``group``: the merged fp32 output (B, S/W, H,
    hd) and lse (B, H, S/W) of the rank's rows (JAX's ``_fused_ring_fwd``).
    At each step the shift of the chunk held to the next rank is posted,
    the step's block launched, and the shift waited on; the last step
    shifts nothing. ``plain`` runs the plain block on any device."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    B, S, H, hd = q.shape
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    block = ring_fwd_block_plain if plain else ring_fwd_block
    kv = (k, v)
    for step in range(world):
        chunk = ring_source(step, rank, world)
        shift = (torch_compat.shift_start(kv, group, _ring_perm(world))
                 if step < world - 1 else None)
        if _computes(chunk, rank, causal):
            block(q, *kv, o, lse, diagonal=causal and step == 0,
                  first=step == 0, sm_scale=sm_scale)
        if shift is not None:
            kv = tuple(shift.wait())
    return o, lse


def ring_backward_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, group, causal: bool = True,
                        sm_scale: Optional[float] = None, plain: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The W ring steps of the backward on this rank's shard (JAX's
    ``_fused_ring_bwd``): delta and dq stay on the rank; dk and dv ride the
    ring with their chunk, shifted after each step's block, and after W
    shifts land back on the chunk's home rank (:301-307). Returns fp32
    (dq, dk, dv) of the rank's shard."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    perm = _ring_perm(world)
    delta = ring_delta(o, do)
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    block = ring_bwd_block_plain if plain else ring_bwd_block
    kv = (k, v)
    for step in range(world):
        chunk = ring_source(step, rank, world)
        shift = (torch_compat.shift_start(kv, group, perm)
                 if step < world - 1 else None)
        if _computes(chunk, rank, causal):
            block(q, *kv, do, lse, delta, dq, dk, dv,
                  diagonal=causal and step == 0, first=step == 0,
                  sm_scale=sm_scale)
        dk, dv = torch_compat.shift_start((dk, dv), group, perm).wait()
        if shift is not None:
            kv = tuple(shift.wait())
    return dq, dk, dv


def ring_by_rank(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, *, world: int, causal: bool = True,
                 sm_scale: Optional[float] = None, plain: bool = False):
    """The process ring's launches with every rank on this one device: q, k,
    v, do the whole (B, S, H, hd) sequence of W = ``world`` shards, and at
    each step one ``ring_fwd_block`` (then ``ring_bwd_block``) per rank that
    computes, on its rows and the chunk it holds, the chunk's dk and dv
    accumulated in the order they ride the ring. Returns the fp32 (o, lse,
    dq, dk, dv) of the whole sequence: what ``ring_forward``/
    ``ring_backward``'s folded launches give, which the card's checks hold
    it to bit for bit (``plain`` runs the plain blocks)."""
    B, S, H, hd = q.shape
    shard = S // world
    rows = [_rows(r, shard) for r in range(world)]
    part = [[x[:, rs] for rs in rows] for x in (q, k, v, do)]
    f32 = dict(dtype=torch.float32, device=q.device)
    o = [torch.empty((B, shard, H, hd), **f32) for _ in rows]
    lse = [torch.empty((B, H, shard), **f32) for _ in rows]
    fwd = ring_fwd_block_plain if plain else ring_fwd_block
    bwd = ring_bwd_block_plain if plain else ring_bwd_block
    for step in range(world):
        for r in range(world):
            c = ring_source(step, r, world)
            if _computes(c, r, causal):
                fwd(part[0][r], part[1][c], part[2][c], o[r], lse[r],
                    diagonal=causal and step == 0, first=step == 0,
                    sm_scale=sm_scale)
    delta = [ring_delta(o[r], part[3][r]) for r in range(world)]
    dq, dk, dv = ([torch.empty((B, shard, H, hd), **f32) for _ in rows]
                  for _ in range(3))
    for step in range(world):
        for r in range(world):
            c = ring_source(step, r, world)
            if _computes(c, r, causal):
                bwd(part[0][r], part[1][c], part[2][c], part[3][r], lse[r],
                    delta[r], dq[r], dk[c], dv[c],
                    diagonal=causal and step == 0, first=step == 0,
                    sm_scale=sm_scale)
    return (torch.cat(o, 1), torch.cat(lse, 2), torch.cat(dq, 1),
            torch.cat(dk, 1), torch.cat(dv, 1))


class ProcessRing(torch.autograd.Function):
    """``FusedRing`` across process ranks: the rank's shard in and out, the
    ring's shifts issued from this forward and backward (every rank of the
    group issues the same ones in the same order)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        o, lse = ring_forward_shard(q, k, v, group=group, causal=causal,
                                    sm_scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward_shard(q, k, v, o, lse, do.to(q.dtype),
                                         group=ctx.group, causal=ctx.causal,
                                         sm_scale=ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _einsum_ring_shard(q, k, v, mesh: Mesh, axis: str, causal: bool,
                       scale: float):
    """JAX's einsum body (``:377-422``) on this rank's shard: K/V rotate
    with ``ppermute``, so autograd's backward sends their gradients the
    other way."""
    world, idx = mesh.shape[axis], axis_index(mesh, axis)
    B, S, H, D = q.shape
    dev = q.device
    qpos = idx * S + torch.arange(S, device=dev)
    m = torch.full((B, H, S), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for step in range(world):
        src = ring_source(step, idx, world)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k_cur.float()) * scale
        if causal:
            kpos = src * S + torch.arange(S, device=dev)
            mask = kpos[None, :] <= qpos[:, None]
            scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                          v_cur.float())
        o = o * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if step < world - 1:  # the last rotation's chunk would go unread
            k_cur = torch_compat.ppermute(k_cur, axis, _ring_perm(world),
                                          mesh=mesh)
            v_cur = torch_compat.ppermute(v_cur, axis, _ring_perm(world),
                                          mesh=mesh)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mesh: Mesh, axis_name: str = "seq",
                         causal: bool = True,
                         sm_scale: Optional[float] = None,
                         impl: str = "auto") -> torch.Tensor:
    """Ring attention on this rank's (B, S/W, H, D) shard of a ``seq`` axis
    that spans process ranks (JAX's ``ring_attention_local``): "fused" the
    ring kernels (``ProcessRing``), "einsum" the streaming-LSE body, "auto"
    fused when the shard admits a splash block."""
    if impl == "auto":
        impl = "fused" if _ring_block(q.shape[1]) is not None else "einsum"
    if impl == "fused":
        if _ring_block(q.shape[1]) is None:
            raise ValueError(
                f"fused ring needs S_local ({q.shape[1]}) divisible by a "
                "128-multiple block; use impl='einsum'")
        return ProcessRing.apply(q, k, v,
                                 torch_compat.axis_group(mesh, axis_name),
                                 causal, _scale(q, sm_scale))
    if impl != "einsum":
        raise ValueError(f"impl must be auto|fused|einsum, got {impl!r}")
    return _einsum_ring_shard(q, k, v, mesh, axis_name, causal,
                              _scale(q, sm_scale))


# ------------------------------------------------------------- local bodies
def fused_ring_attention_local(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, world: int,
                               causal: bool = True,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The fused ring body over the whole (B, S, H, hd) sequence of W =
    ``world`` shards. As in JAX, S / W must admit a splash block (a multiple
    of 128), though the Hopper kernels themselves take any length."""
    shard = q.shape[1] // world
    if _ring_block(shard) is None:
        raise ValueError(
            f"fused ring needs S_local ({shard}) divisible by a 128-multiple "
            "block; use impl='einsum'")
    return FusedRing.apply(q, k, v, world, causal, _scale(q, sm_scale))


def _einsum_ring(q, k, v, world, causal, scale):
    """JAX's einsum body (``:377-422``), every rank at once: shards stacked
    on a rank axis, (B, W, S_local, H, D)."""
    B, S, H, D = q.shape
    shard = S // world
    qs, ks, vs = (x.unflatten(1, (world, shard)) for x in (q, k, v))
    dev = q.device
    pos = torch.arange(shard, device=dev)
    qpos = torch.arange(world, device=dev)[:, None] * shard + pos  # (W, S_l)
    m = torch.full((B, world, H, shard), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, world, H, shard), dtype=torch.float32, device=dev)
    o = torch.zeros((B, world, shard, H, D), dtype=torch.float32, device=dev)
    for step in range(world):
        src = torch.tensor([ring_source(step, r, world) for r in range(world)],
                           device=dev)
        k_cur, v_cur = ks[:, src], vs[:, src]
        scores = torch.einsum("bwqhd,bwkhd->bwhqk", qs.float(),
                              k_cur.float()) * scale
        if causal:
            kpos = src[:, None] * shard + pos                      # (W, S_l)
            mask = (kpos[:, None, :] <= qpos[:, :, None])[None, :, None]
            scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        if causal:
            # exp(_NEG - _NEG) == 1 on fully-masked rows: zero them by hand.
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bwhqk,bwkhd->bwqhd", p.to(v.dtype).float(),
                          v_cur.float())
        o = o * corr.transpose(2, 3)[..., None] + pv
        m = m_new
    out = o / l.clamp_min(1e-30).transpose(2, 3)[..., None]
    return out.to(q.dtype).flatten(1, 2)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, world: int, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         impl: str = "auto") -> torch.Tensor:
    """Ring attention over the whole (B, S, H, D) sequence of W = ``world``
    shards (JAX's shard_map body, which sees one (B, S/W, H, D) shard).

    impl="fused" runs ``FusedRing`` (the kernels on CUDA), "einsum" the
    streaming-LSE body, "auto" fused when S/W admits a splash block.
    """
    if impl == "auto":
        impl = "fused" if _ring_block(q.shape[1] // world) is not None \
            else "einsum"
    if impl == "fused":
        return fused_ring_attention_local(q, k, v, world=world, causal=causal,
                                          sm_scale=sm_scale)
    if impl != "einsum":
        raise ValueError(f"impl must be auto|fused|einsum, got {impl!r}")
    return _einsum_ring(q, k, v, world, causal, _scale(q, sm_scale))


# ----------------------------------------------------------------- Ulysses
def _seq_to_heads(x: torch.Tensor, world: int) -> torch.Tensor:
    """all_to_all (B, S/W, H, D) per rank -> (B, S, H/W, D) per rank. On the
    folded shards: (B, S, H, D) -> (W * B, S, H/W, D), rank-major."""
    return x.unflatten(2, (world, x.shape[2] // world)).permute(
        2, 0, 1, 3, 4).flatten(0, 1)


def _heads_to_seq(x: torch.Tensor, world: int) -> torch.Tensor:
    """The inverse all_to_all: (W * B, S, H/W, D) -> (B, S, H, D)."""
    return x.unflatten(0, (world, x.shape[0] // world)).permute(
        1, 2, 0, 3, 4).flatten(2, 3)


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain einsum-softmax-einsum causal attention (fp32 softmax)."""
    scale = _scale(q, sm_scale)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S, K = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(S, K, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, world: int,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            attn_fn: Optional[Callable] = None
                            ) -> torch.Tensor:
    """all_to_all to (full sequence, H/W heads) per rank, attention per head
    shard, then the inverse reshard. ``attn_fn`` sees the W ranks' shards
    folded into the batch, (W * B, S, H/W, D)."""
    H = q.shape[2]
    if H % world != 0:
        raise ValueError(f"Ulysses needs heads ({H}) % seq axis ({world}) == 0")
    if world > 1:
        q, k, v = (_seq_to_heads(x, world) for x in (q, k, v))
    if attn_fn is None:
        attn_fn = partial(_xla_attention, causal=causal, sm_scale=sm_scale)
    out = attn_fn(q, k, v)
    if world > 1:
        out = _heads_to_seq(out, world)
    return out


def ulysses_attention_shard(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, mesh: Mesh,
                            axis_name: str = "seq", causal: bool = True,
                            sm_scale: Optional[float] = None,
                            attn_fn: Optional[Callable] = None
                            ) -> torch.Tensor:
    """Ulysses on this rank's (B, S/W, H, D) shard of a ``seq`` axis that
    spans process ranks: ``all_to_all`` to (B, S, H/W, D), attention over
    the whole sequence for the rank's heads, and the inverse reshard."""
    world = mesh.shape[axis_name]
    H = q.shape[2]
    if H % world != 0:
        raise ValueError(f"Ulysses needs heads ({H}) % seq axis ({world}) == 0")
    if world > 1:
        q, k, v = (torch_compat.all_to_all(x, axis_name, 2, 1, mesh=mesh)
                   for x in (q, k, v))
    if attn_fn is None:
        attn_fn = partial(_xla_attention, causal=causal, sm_scale=sm_scale)
    out = attn_fn(q, k, v)
    if world > 1:
        out = torch_compat.all_to_all(out, axis_name, 1, 2, mesh=mesh)
    return out


# --------------------------------------------------------------- mesh APIs
def _resolve(mesh: Optional[MeshLike]) -> Mesh:
    resolved = current_mesh() if mesh is None else make_mesh(mesh)
    if resolved is None:
        raise ValueError(
            "context-parallel attention needs a mesh: pass mesh= or call it "
            "under ray_tpu_torch.parallel.use_mesh(...)")
    return resolved


def _across(mesh: Mesh, axis_name: str) -> bool:
    """Whether ``axis_name`` spans process ranks on ``mesh`` (else it is
    folded onto this device)."""
    return mesh.device_mesh is not None and axis_name in mesh.dim_names


def _on_shards(fn, q, k, v, axis_name: str, batch_axes):
    """``fn`` on each rank's local shards of DTensor q, k, v (JAX's
    ``shard_map`` with ``P(batch_axes, axis_name, "tensor", None)``)."""
    mesh = Mesh.of(q)
    spec = PartitionSpec(tuple(batch_axes), axis_name, "tensor", None)
    return torch_compat.shard_map(partial(fn, mesh=mesh), mesh=mesh,
                                  in_specs=(spec,) * 3, out_specs=spec)(
                                      q, k, v)


def _seq_world(q, k, v, mesh: Mesh, axis_name: str) -> int:
    _check(q, k, v)
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}")
    world = mesh.shape[axis_name]
    if q.shape[1] % world:
        raise ValueError(
            f"sequence length {q.shape[1]} is not divisible by the "
            f"{axis_name!r} axis ({world})")
    return world


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Optional[MeshLike] = None, axis_name: str = "seq",
                   causal: bool = True, sm_scale: Optional[float] = None,
                   batch_axes=("data", "fsdp"), impl: str = "auto"
                   ) -> torch.Tensor:
    """Context-parallel causal attention over (B, S, H, D) sharded on the
    ``axis_name`` axis. With mesh=None the ambient mesh (``use_mesh``) is
    used. When the axis spans process ranks, q, k, v are either DTensors on
    the mesh (each rank runs its shards, ``batch_axes`` naming the batch's
    axes) or the rank's own (B, S/W, H, D) shards, as inside a shard_map
    body. When it is folded, they are the whole sequence and ``batch_axes``
    has no effect."""
    if torch_compat.is_dtensor(q):
        return _on_shards(
            partial(ring_attention_shard, axis_name=axis_name, causal=causal,
                    sm_scale=sm_scale, impl=impl),
            q, k, v, axis_name, batch_axes)
    resolved = _resolve(mesh)
    if _across(resolved, axis_name):
        _check(q, k, v)
        return ring_attention_shard(q, k, v, mesh=resolved,
                                    axis_name=axis_name, causal=causal,
                                    sm_scale=sm_scale, impl=impl)
    world = _seq_world(q, k, v, resolved, axis_name)
    return ring_attention_local(q, k, v, world=world, causal=causal,
                                sm_scale=sm_scale, impl=impl)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: Optional[MeshLike] = None, axis_name: str = "seq",
                      causal: bool = True, sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None,
                      batch_axes=("data", "fsdp")) -> torch.Tensor:
    """Ulysses sequence parallelism over seq-sharded (B, S, H, D): DTensors
    or the rank's own shards when the axis spans process ranks (as
    ``ring_attention``), the whole sequence when it is folded."""
    if torch_compat.is_dtensor(q):
        return _on_shards(
            partial(ulysses_attention_shard, axis_name=axis_name,
                    causal=causal, sm_scale=sm_scale, attn_fn=attn_fn),
            q, k, v, axis_name, batch_axes)
    resolved = _resolve(mesh)
    if _across(resolved, axis_name):
        _check(q, k, v)
        return ulysses_attention_shard(q, k, v, mesh=resolved,
                                       axis_name=axis_name, causal=causal,
                                       sm_scale=sm_scale, attn_fn=attn_fn)
    world = _seq_world(q, k, v, resolved, axis_name)
    return ulysses_attention_local(q, k, v, world=world, causal=causal,
                                   sm_scale=sm_scale, attn_fn=attn_fn)
