"""Device resolution for the port: the GPU by default, the CPU only on request.

Counterpart of ``ray_tpu/_private/accelerators.py``, which detects the TPU
chips of a host. Here every entry point takes a ``device`` argument: ``None``
means the first CUDA device, and a caller that wants the CPU (the tests) says
so with ``device="cpu"``. Without a GPU, the default raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device raises when no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch finds no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (use cuda or cpu)")
    return dev


def gpu_count() -> int:
    """The CUDA devices torch sees, without creating a CUDA context: the
    runtime registers them as its ``GPU`` resource."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def granted_cuda_device() -> torch.device:
    """The card of the calling task or actor: the first GPU index its lease
    was granted (``ray_tpu_torch.get_gpu_ids``), else this thread's current
    device. Replicas on one host thus run each on the card the runtime
    counted for it."""
    import ray_tpu_torch

    ids = ray_tpu_torch.get_gpu_ids()
    return torch.device("cuda", ids[0] if ids else torch.cuda.current_device())
