"""Accelerator detection for the head node (the counterpart of
``ray_tpu/_private/accelerators.py:detect_accelerators``, which finds a
host's TPU chips; ref: python/ray/_private/accelerators/nvidia_gpu.py).

The host's CUDA devices become the ``GPU`` resource, and the first card's
name the node label ``accelerator-type``. The count goes through
``device.gpu_count`` and creates no CUDA context; the name is read only
when torch has a card to name.
"""

from __future__ import annotations

from typing import Dict, Tuple


def detect_accelerators() -> Tuple[Dict[str, float], Dict[str, str]]:
    """(resources, node labels) of this host's cards."""
    from ray_tpu_torch._private.device import gpu_count

    n = gpu_count()
    if not n:
        return {}, {}
    import torch

    labels = {}
    if torch.cuda.is_available():  # else a count given by a caller
        labels["accelerator-type"] = \
            torch.cuda.get_device_name(0).replace(" ", "-")
    return {"GPU": float(n)}, labels
