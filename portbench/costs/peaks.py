"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full power limit)."""

from __future__ import annotations

__all__ = ["PEAKS", "lookup"]

PEAKS = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def lookup(device_name: str):
    """The peaks of a card by its ``torch.cuda.get_device_name``, or
    None for a card not in the table."""
    for key, peak in PEAKS.items():
        if key in device_name:
            return peak
    return None
