"""Fused LM-head cross-entropy: the port of ``ray_tpu/ops/fused_ce.py``.

``fused_lm_head_ce`` computes ``mean(logsumexp(x W^T) - x W^T[target])``
without the (B*S, V) logits in device memory: on CUDA tensors the forward
runs the hand-written Hopper kernel ``fused_ce_fwd`` (an online logsumexp
over vocab tiles) and the backward ``fused_ce_dx`` and ``fused_ce_dw``
(each recomputes its logits tiles), all three in ``csrc/fused_ce.cu``. On CPU
tensors the same ``torch.autograd.Function`` runs the plain PyTorch versions
``ce_fwd_reference``, ``ce_dx_reference`` and ``ce_dw_reference``. A CUDA
tensor goes through the kernels or raises; nothing falls back.

``bwd_impl="xla"`` is the reference's middle path: the fused forward, then
one recompute of the logits and a materialised dlogits in the backward, as
plain matrix products (JAX ran them outside any Pallas kernel too).

The reference's ``fused_ce_wins`` is a roofline model with TPU v5e constants
that gates ``loss_impl="auto"`` on a TPU; the port has no such gate
(``"auto"`` is dense) and does not carry it.

``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ray_tpu_torch._private import kernel_build
from ray_tpu_torch._private.torch_compat import is_dtensor

#: Launches per kernel since the last reset; only a kernel launch adds one.
LAUNCHES: Dict[str, int] = {"fused_ce_fwd": 0, "fused_ce_dx": 0,
                            "fused_ce_dw": 0}

#: Hidden widths the kernels are compiled for (register tiles sized at
#: compile time; see csrc/fused_ce.cu).
KERNEL_WIDTHS = (64, 128, 768)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _logits(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits x2 @ w^T. bf16 operands are upcast: each product of two
    bf16 values is exact in fp32, so this is a bf16 product with fp32
    accumulation (JAX's ``preferred_element_type=float32``)."""
    return x2.float() @ w.float().t()


def _p_minus_onehot(x2, w, t, lse) -> torch.Tensor:
    p = torch.exp(_logits(x2, w) - lse.float()[:, None])
    rows = torch.arange(x2.shape[0], device=x2.device)
    p[rows, t.long()] -= 1.0
    return p


def ce_fwd_reference(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: x2 (N, D), w (V, D), t (N,) ->
    (lse, tgt), each (N,) fp32."""
    logits = _logits(x2, w)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, t.long()[:, None])[:, 0]
    return lse, tgt


def ce_dx_reference(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                    lse: torch.Tensor) -> torch.Tensor:
    """Plain version of the dx kernel: sum_v (softmax - onehot) W, with
    (softmax - onehot) rounded to w's type first (``_dx_kernel`` :127).
    (N, D) fp32, unscaled."""
    p = _p_minus_onehot(x2, w, t, lse).to(w.dtype)
    return p.float() @ w.float()


def ce_dw_reference(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
                    lse: torch.Tensor) -> torch.Tensor:
    """Plain version of the dW kernel: sum_n (softmax - onehot)^T x, with
    (softmax - onehot) rounded to x's type first (``_dw_kernel`` :146).
    (V, D) fp32, unscaled."""
    p = _p_minus_onehot(x2, w, t, lse).to(x2.dtype)
    return p.float().t() @ x2.float()


def _kernel_inputs(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor):
    for name, a in (("x", x2), ("wte", w)):
        if a.dtype != torch.bfloat16:
            raise TypeError(
                f"the fused CE kernels take bfloat16 on CUDA; {name} is {a.dtype}")
    D = x2.shape[1]
    if D not in KERNEL_WIDTHS:
        raise ValueError(
            f"the fused CE kernels take a hidden width in {KERNEL_WIDTHS}, "
            f"got {D}")
    if x2.shape[0] > 2**31 - 1 or w.shape[0] > 2**31 - 1:
        raise ValueError("N and V must fit in int32")
    return _aligned(x2), _aligned(w), t.to(torch.int32).contiguous()


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous and starting on 16 bytes, as the kernels' TMA
    tensor maps require: a view that starts elsewhere is copied."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


def _fn(name: str):
    fn = getattr(kernel_build.load("fused_ce"), name)
    if fn.argtypes is None:
        # c_void_p for every pointer and the stream: ctypes would pass a
        # bare Python int as a 32-bit int and cut the pointer.
        fn.argtypes = [_PTR] * 5 + [_I32] * 3 + [_PTR]
        fn.restype = _I32
    return fn


def _run(name: str, x2, w, t, a, b) -> None:
    (N, D), V = x2.shape, w.shape[0]
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _fn(name)(x2.data_ptr(), w.data_ptr(), t.data_ptr(),
                        a.data_ptr(), b.data_ptr(), N, V, D, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def ce_fwd(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, tgt), each (N,) fp32: the kernel on CUDA, the plain version on
    the CPU."""
    if x2.device.type == "cpu":
        return ce_fwd_reference(x2, w, t)
    x2, w, t = _kernel_inputs(x2, w, t)
    lse = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    tgt = torch.empty_like(lse)
    _run("fused_ce_fwd", x2, w, t, lse, tgt)
    return lse, tgt


def ce_dx(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
          lse: torch.Tensor) -> torch.Tensor:
    """Unscaled dx (N, D) fp32: the kernel on CUDA, the plain version on the
    CPU."""
    if x2.device.type == "cpu":
        return ce_dx_reference(x2, w, t, lse)
    x2, w, t = _kernel_inputs(x2, w, t)
    dx = torch.empty(x2.shape, dtype=torch.float32, device=x2.device)
    _run("fused_ce_dx", x2, w, t, lse.to(torch.float32).contiguous(), dx)
    return dx


def ce_dw(x2: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
          lse: torch.Tensor) -> torch.Tensor:
    """Unscaled dW (V, D) fp32: the kernel on CUDA, the plain version on the
    CPU."""
    if x2.device.type == "cpu":
        return ce_dw_reference(x2, w, t, lse)
    x2, w, t = _kernel_inputs(x2, w, t)
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    _run("fused_ce_dw", x2, w, t, lse.to(torch.float32).contiguous(), dw)
    return dw


class FusedCE(torch.autograd.Function):
    """Mirror of the reference's ``_fused_ce`` custom_vjp (:184-246): the
    forward saves (x2, w, t2, lse) and returns the mean loss; the backward
    scales by g / N and casts dx to x's type and dW to w's (:243)."""

    @staticmethod
    def forward(ctx, x2, w, t2, bwd_impl: str):
        if x2.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {x2.device}")
        lse, tgt = ce_fwd(x2, w, t2)
        ctx.save_for_backward(x2, w, t2, lse)
        ctx.bwd_impl = bwd_impl
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        x2, w, t2, lse = ctx.saved_tensors
        scale = (g / x2.shape[0]).to(torch.float32)
        if ctx.bwd_impl == "pallas":
            dx = ce_dx(x2, w, t2, lse) * scale
            dw = ce_dw(x2, w, t2, lse) * scale
        else:  # "xla": one recompute, dlogits materialises
            dlogits = (_p_minus_onehot(x2, w, t2, lse) * scale).to(x2.dtype)
            dx = dlogits.float() @ w.float()
            dw = dlogits.float().t() @ x2.float()
        return dx.to(x2.dtype), dw.to(w.dtype), None, None


def fused_lm_head_ce(x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
                     block_rows: int = 1024, bwd_impl: str = "pallas"
                     ) -> torch.Tensor:
    """Mean token cross-entropy of a tied LM head, logits never in device
    memory.

    x: (B, S, D) hidden states; wte: (V, D), cast to x's type; targets:
    (B, S) int. bwd_impl: "pallas" = the fully fused backward kernels (two
    logits recomputes, no logits in memory); "xla" = one recompute with a
    materialised dlogits. ``block_rows`` is the TPU kernel's tile size and
    has no effect here.
    """
    del block_rows
    if bwd_impl not in ("pallas", "xla"):
        raise ValueError(f"bwd_impl must be pallas|xla, got {bwd_impl!r}")
    if any(is_dtensor(a) for a in (x, wte, targets)):
        raise TypeError("the fused CE takes a rank's local tensors; on a "
                        "device mesh call it under shard_map")
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    t2 = targets.reshape(b * s)
    return FusedCE.apply(x2, wte.to(x.dtype), t2, bwd_impl)
