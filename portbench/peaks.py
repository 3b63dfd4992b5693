"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
dense rates without sparsity, at the full power limit; the run prints the
card's limit beside every number it reports)."""

from __future__ import annotations

from typing import Optional

# name as torch.cuda.get_device_name gives it -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # the SXM part
        "float32": 67e12,  # outside the tensor cores: fp32 with TF32 off
        "tf32": 495e12,
        "bfloat16": 989e12,
        "bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, what: str) -> Optional[float]:
    """The peak ``what`` (a dtype's FLOP/s, or ``bytes_per_s``) of the card
    named ``kind``; None for a card the table does not hold."""
    return PEAKS.get(kind, {}).get(what)
