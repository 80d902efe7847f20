"""Device resolution for the port: the GPU by default, the CPU only on request.

Counterpart of ``ray_tpu/_private/accelerators.py``, which detects the TPU
chips of a host. Here every entry point takes a ``device`` argument: ``None``
means the first CUDA device, and a caller that wants the CPU (the tests) says
so with ``device="cpu"``. Without a GPU, the default raises instead of
quietly running on the CPU.

torch is imported by the functions that use it: the runtime's modules load
this one, and a process worker that runs no torch code starts without it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Union

if TYPE_CHECKING:
    import torch

DeviceLike = Union[str, "torch.device", None]


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """``None`` -> ``cuda``; a CUDA device raises when no GPU is present."""
    import torch

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
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def local_gpu_index(gpu_id: int) -> int:
    """This process's CUDA index of the card the driver numbers ``gpu_id``.
    A process worker sees exactly its lease's cards, in the lease's order
    (``_private/process_pool.py``); one that was granted no such card
    raises."""
    from ray_tpu_torch._private import process_pool

    if process_pool.WORKER_MAIN_AT is None:  # the driver: its own numbering
        return gpu_id
    ids = list(process_pool.worker_gpu_ids())
    if gpu_id not in ids:
        raise RuntimeError(
            f"this process worker was granted cards {ids}, not {gpu_id}")
    return ids.index(gpu_id)


def granted_cuda_device() -> "torch.device":
    """The card of the calling task or actor: the first GPU index its lease
    was granted (``ray_tpu_torch.get_gpu_ids``), as this process numbers it,
    else this thread's current device. Replicas on one host thus run each on
    the card the runtime counted for it, in the driver or in a worker."""
    import torch

    import ray_tpu_torch

    ids = ray_tpu_torch.get_gpu_ids()
    return torch.device("cuda", local_gpu_index(ids[0]) if ids
                        else torch.cuda.current_device())
