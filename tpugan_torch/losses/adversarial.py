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


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(logits, int labels), mean-reduced
    (``tpugan/losses/adversarial.py:cross_entropy_logits``)."""
    return F.cross_entropy(logits.float(), labels.long())


def cross_entropy_on_softmax(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's double-softmax quirk (acgan/acgan.py:100,113,
    sgan/sgan.py:99,112, infogan/infogan.py:111,126): Softmax outputs fed to
    CrossEntropyLoss, which treats the probabilities as logits
    (``tpugan/losses/adversarial.py:48-61``). Kept for parity."""
    return cross_entropy_logits(probs, labels)
