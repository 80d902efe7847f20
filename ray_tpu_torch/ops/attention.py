"""Fused attention on the GPU: the port of ``ray_tpu/ops/attention.py``.

``splash_attention`` and ``flash_attention`` keep the JAX package's layout,
(B, S, H, head_dim) in and out, and both go through ``SplashAttention``, a
``torch.autograd.Function`` (the counterpart of the ``jax.custom_vjp`` inside
the Pallas splash kernel). On CUDA tensors its forward runs the hand-written
Hopper kernel ``csrc/splash_attention_fwd.cu`` and its backward
``csrc/splash_attention_bwd.cu``; the two TPU kernels compute the same
function, and their TPU block sizes are accepted and ignored. On CPU tensors
the same Function runs the plain PyTorch versions, ``attention_reference``
and ``attention_bwd_reference``, so the CPU tests exercise the backward
formula the kernel computes. A CUDA tensor goes through the kernels or
raises; nothing falls back to a plain version on the card, and no detached
kernel output enters an autograd graph.

``LAUNCHES`` counts the kernels' launches (one per wrapper call), so a run
can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch._private import kernel_build
from ray_tpu_torch._private.torch_compat import is_dtensor

#: Launches per kernel since the last reset; only a kernel launch adds one.
LAUNCHES: Dict[str, int] = {"splash_attention_fwd": 0,
                             "splash_attention_bwd": 0}
#: Serve replicas launch from many threads at once; ``+=`` on a dict entry
#: is not atomic.
_LAUNCHES_LOCK = threading.Lock()

#: The splash mask's DEFAULT_MASK_VALUE: finite, so that a fully masked row
#: gives no exp(-inf - -inf) = NaN.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention, the XLA path of ``ray_tpu/models/gpt2.py``:
    fp32 scores, a finite mask value, fp32 softmax, probabilities cast to the
    input type before the product with v.

    q, k, v: (B, S, H, hd). Returns o (B, S, H, hd) in q's type and the
    natural-log logsumexp of the scaled, masked scores, (B, H, S) fp32.
    """
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S, K = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(S, K, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, MASK_VALUE)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype), lse


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            delta: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention backward, FlashAttention-2 style, in fp32.

    q, k, v, o, do: (B, S, H, hd); lse: the forward's natural-log logsumexp,
    (B, H, S). ``delta`` (B, H, S) defaults to rowsum(o * do). With
    s = q k^T * scale (masked) and p = exp(s - lse):
    dv = p^T do, dp = do v^T, ds = p (dp - delta), dq = scale ds k,
    dk = scale ds^T q. Returns (dq, dk, dv) in the types of q, k, v.
    """
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    if delta is None:
        delta = (o.float() * dof).sum(-1).transpose(1, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        S, K = s.shape[-2], s.shape[-1]
        mask = torch.ones(S, K, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if any(is_dtensor(t) for t in (q, k, v)):
        raise TypeError("the splash kernels take a rank's local tensors; on "
                        "a device mesh call them under shard_map")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "q, k, v must share one (B, S, H, head_dim) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def _row_aligned(x: torch.Tensor) -> bool:
    """Each row of head_dim elements contiguous, the base and every other
    stride a positive multiple of 16 bytes: what the forward kernel's tensor
    maps take (and the backward's 16-byte copies)."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in x.stride()[:-1]))


def _kernel_inputs(named: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Checks what the kernels take (bfloat16, head_dim 64 or 128, B*H
    within the grid) and returns the tensors with every row contiguous and
    16-byte aligned. Strided views (q, k, v split from the fused qkv) are
    taken as they are; anything else is copied into new storage."""
    for name, x in named.items():
        if x.dtype != torch.bfloat16:
            raise TypeError(
                f"the splash kernels take bfloat16 on CUDA; {name} is {x.dtype}")
    B, S, H, hd = next(iter(named.values())).shape
    if hd not in _HEAD_DIMS:
        raise ValueError(
            f"the splash kernels take head_dim in {_HEAD_DIMS}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernels' grid (65535)")
    return tuple(x if _row_aligned(x)
                 else x.clone(memory_format=torch.contiguous_format)
                 for x in named.values())


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _splash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    q, k, v = _kernel_inputs({"q": q, "k": k, "v": v})
    B, S, H, hd = q.shape
    o = torch.empty((B, S, H, hd), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if S == 0:
        return o, lse
    fn = _fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, S, H, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], scale, int(causal), stream)
    _launch("splash_attention_fwd", err)
    return o, lse


def _splash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     delta: Optional[torch.Tensor], causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v, o, do = _kernel_inputs(
        {"q": q, "k": k, "v": v, "o": o, "do": do})
    B, S, H, hd = q.shape
    lse = lse.to(torch.float32).contiguous()
    compute_delta = delta is None
    if compute_delta:
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    else:
        delta = delta.to(torch.float32).contiguous()
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (B, H, S):
            raise ValueError(
                f"{name} must be (B, H, S) = {(B, H, S)}, got {tuple(x.shape)}")
    dq, dk, dv = (torch.empty((B, S, H, hd), dtype=torch.bfloat16,
                              device=q.device) for _ in range(3))
    if S == 0:
        return dq, dk, dv
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, S, H, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], *do.stride()[:3], scale, int(causal),
                 int(compute_delta), stream)
    _launch("splash_attention_bwd", err)
    return dq, dk, dv


# c_void_p for every pointer and the stream: ctypes would pass a bare Python
# int as a 32-bit int and cut the pointer.
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fwd_fn():
    fn = kernel_build.load("splash_attention_fwd").splash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * 5 + [_I32] * 4 + [_I64] * 9
                       + [ctypes.c_float, _I32, _PTR])
        fn.restype = _I32
    return fn


def _bwd_fn():
    fn = kernel_build.load("splash_attention_bwd").splash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * 10 + [_I32] * 4 + [_I64] * 15
                       + [ctypes.c_float, _I32, _I32, _PTR])
        fn.restype = _I32
    return fn


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def splash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                         *, causal: bool = True,
                         sm_scale: Optional[float] = None,
                         delta: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of splash attention from the forward's o and natural-log
    lse (B, H, S). ``delta`` (B, H, S) fp32 defaults to rowsum(o * do); a
    caller that merges several partial attentions (the ring) passes its
    global lse and delta here.

    CUDA tensors (bfloat16, head_dim 64 or 128) run the Hopper kernel; CPU
    tensors run ``attention_bwd_reference``.
    """
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                       sm_scale=scale, delta=delta)
    if q.device.type == "cuda":
        return _splash_bwd_cuda(q, k, v, o, lse, do, delta, causal, scale)
    raise ValueError(f"unsupported device {q.device}")


class SplashAttention(torch.autograd.Function):
    """Attention with the kernels' own gradient: the forward saves
    (q, k, v, o, lse), the backward runs ``splash_attention_bwd`` on them.
    Returns (o, lse); lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            o, lse = attention_reference(q, k, v, causal=causal,
                                         sm_scale=scale)
        elif q.device.type == "cuda":
            o, lse = _splash_fwd_cuda(q, k, v, causal, scale)
        else:
            raise ValueError(f"unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = splash_attention_bwd(q, k, v, o, lse, do,
                                          causal=ctx.causal,
                                          sm_scale=ctx.scale)
        return dq, dk, dv, None, None


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, sm_scale: Optional[float] = None,
                     block_q: int = 512, block_kv: int = 512,
                     return_lse: bool = False):
    """Causal (or full, ``causal=False``) multi-head attention.

    q, k, v: (B, S, H, head_dim), the model's layout. Scaling is
    1/sqrt(head_dim) unless given. ``block_q``/``block_kv`` are the TPU
    kernel's tile sizes and have no effect here. With ``return_lse`` also
    returns the natural-log logsumexp of the scaled scores, (B, H, S) fp32.
    Differentiable through ``SplashAttention``.

    CUDA tensors (bfloat16, head_dim 64 or 128) run the Hopper kernels; CPU
    tensors run the plain versions.
    """
    del block_q, block_kv
    _check(q, k, v)
    o, lse = SplashAttention.apply(q, k, v, causal, _scale(q, sm_scale))
    return (o, lse) if return_lse else o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block: int = 1024) -> torch.Tensor:
    """The same function as ``splash_attention``, gradient included (the
    TPU package ran it on the stock Pallas flash kernels); ``block`` has no
    effect here."""
    del block
    return splash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
