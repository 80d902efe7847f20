"""Published dense peaks of the GPUs the port measures itself against.

One table for the whole port: ``chip_smoke.py`` and ``ray_tpu_torch.bench``
both read it. Keys are substrings of ``torch.cuda.get_device_name()``;
values are (device-memory bytes/s, dense bf16 tensor-core flop/s) from
NVIDIA's data sheets, at the card's full power limit. A card that is not in
the table raises: a utilisation against a guessed peak would be wrong.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAKS: Dict[str, Tuple[float, float]] = {
    "H100 80GB HBM3": (3.35e12, 989e12),  # H100 SXM
    "H100 SXM": (3.35e12, 989e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H200": (4.8e12, 989e12),
}


def peaks_for(name: str) -> Tuple[float, float]:
    """(bytes/s, bf16 flop/s) of the card called ``name``; KeyError for a
    card not in ``PEAKS``."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise KeyError(f"no published peaks for {name!r}; add it to PEAKS")
