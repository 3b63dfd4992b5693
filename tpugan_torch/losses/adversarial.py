"""Loss functions with torch.nn loss semantics (``tpugan/losses/adversarial.py``),
mean-reduced over all elements; a scalar target broadcasts."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target) -> torch.Tensor:
    """torch.nn.MSELoss: the LSGAN-family adversarial loss."""
    return torch.mean((pred.float() - target) ** 2)


def l1(pred: torch.Tensor, target) -> torch.Tensor:
    """torch.nn.L1Loss."""
    return torch.mean(torch.abs(pred.float() - target))
