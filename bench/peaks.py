"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit (the run prints the card's limit beside every share).
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,  # CUDA cores, outside the tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not know
    (the readers of shares then report nothing)."""
    return PEAKS.get(device_name)
