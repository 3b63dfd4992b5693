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


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (``tpugan/losses/adversarial.py:25``), the
    relativistic losses' (relativistic_gan/relativistic_gan.py:84);
    ``target`` a scalar, broadcast over ``logits``."""
    logits = logits.float()
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


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


def boundary_seeking(d_out: torch.Tensor) -> torch.Tensor:
    """BGAN's generator loss ``0.5 * mean((log D - log(1 - D))^2)``
    (``tpugan/losses/adversarial.py:70``, bgan/bgan.py:85-90) on D's
    probabilities."""
    d_out = d_out.float()
    return 0.5 * torch.mean((torch.log(d_out) - torch.log(1.0 - d_out)) ** 2)


def pullaway(embeddings: torch.Tensor) -> torch.Tensor:
    """EBGAN's pull-away term as the reference computes it
    (``tpugan/losses/adversarial.py:76``, ebgan/ebgan.py:140-146): the
    pairwise cosine similarities of the N embeddings, unsquared (the paper
    squares them), summed, less the N on the diagonal, over N(N-1)."""
    e = embeddings.reshape(embeddings.shape[0], -1).float()
    ne = e / torch.sqrt(torch.sum(e * e, dim=1, keepdim=True))
    n = e.shape[0]
    return (torch.sum(ne @ ne.T) - n) / (n * (n - 1))
