"""The generic gradient penalty (``tpugan/ops/penalty.py:wgan_gp_penalty``):
dD/dx through ``torch.autograd.grad(create_graph=True)``, differentiated
again by the loss's ``backward()`` (wgan_gp/wgan_gp.py:119-138). It works for
any critic; the template-A MLP critic takes the closed form of
``tpugan_torch.ops.mlp_gp`` instead.

``dragan_penalty`` and ``wdiv_penalty`` come with their trainers (ROADMAP
queue 1, item 3).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt whose subgradient at 0 is 0, as torch's ``Tensor.norm`` backward
    (``penalty.py:_safe_sqrt``): a critic dead zone then gives finite
    parameter gradients, not NaN."""
    nonzero = sq > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)


def wgan_gp_penalty(
    d_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """mean((|dD/dx_interp| - 1)^2) over samples, x_interp = alpha*real
    + (1-alpha)*fake with one alpha per sample, shape (B, 1, 1, 1): passed
    in, or drawn U[0, 1) from ``generator``. The critic's activations must
    have gradient 1 at exactly 0, as JAX's ``where`` gives (the port's
    ``leaky_relu``, not ``F.leaky_relu``), or a dead unit differs from JAX."""
    if alpha is None:
        shape = (real.shape[0],) + (1,) * (real.dim() - 1)
        alpha = torch.rand(shape, generator=generator, device=real.device, dtype=real.dtype)
    interp = (alpha * real + (1.0 - alpha) * fake).requires_grad_(True)
    out = d_fn(interp)
    (grads,) = torch.autograd.grad(out, interp, torch.ones_like(out), create_graph=True)
    norms = _safe_sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1))
    return ((norms - 1.0) ** 2).mean()
