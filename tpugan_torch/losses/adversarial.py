"""Loss functions with torch.nn loss semantics (``tpugan/losses/adversarial.py``),
mean-reduced over all elements; a scalar target broadcasts."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce(probs: torch.Tensor, target: float) -> torch.Tensor:
    """torch.nn.BCELoss (``tpugan/losses/adversarial.py:bce``): both log
    terms clamped at -100, so p in {0, 1} gives a finite loss; the DCGAN
    adversarial loss. ``target`` is a scalar, broadcast over ``probs``."""
    probs = probs.float()
    return F.binary_cross_entropy(probs, torch.full_like(probs, target))


def mse(pred: torch.Tensor, target) -> torch.Tensor:
    """torch.nn.MSELoss: the LSGAN-family adversarial loss."""
    return torch.mean((pred.float() - target) ** 2)


def l1(pred: torch.Tensor, target) -> torch.Tensor:
    """torch.nn.L1Loss."""
    return torch.mean(torch.abs(pred.float() - target))
