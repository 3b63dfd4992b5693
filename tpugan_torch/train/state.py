"""Input normalisation (``tpugan/train/state.py:normalize_uint8``)."""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """NHWC uint8 in, NCHW float32 ``(x/255 - mean)/std`` out, on x's device:
    batches travel as uint8 and are converted after the copy."""
    return ((x.permute(0, 3, 1, 2).float() / 255.0 - mean) / std).contiguous()
