"""Gradient penalties (``tpugan/ops/penalty.py``): dD/dx through
``torch.autograd.grad(create_graph=True)``, differentiated again by the
loss's ``backward()``.

- ``wgan_gp_penalty`` (wgan_gp/wgan_gp.py:119-138) works for any critic;
  the template-A MLP critic takes the closed form of
  ``tpugan_torch.ops.mlp_gp`` instead.
- ``dragan_penalty`` (dragan/dragan.py:142-167): perturbed real data.
- ``wdiv_penalty`` (wgan_div/wgan_div.py:148-163): the Wasserstein
  divergence on real and fake.

The critic's activations must have gradient 1 at exactly 0, as JAX's
``where`` gives (the port's ``leaky_relu``, not ``F.leaky_relu``), or a dead
unit differs from JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpugan_torch.parallel.mesh import DataParallel, global_std


def _safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt whose subgradient at 0 is 0, as torch's ``Tensor.norm`` backward
    (``penalty.py:_safe_sqrt``): a critic dead zone then gives finite
    parameter gradients, not NaN."""
    nonzero = sq > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)


def _grad_wrt_input(d_fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """dD/dx with grad_outputs=ones, the graph kept for the second
    differentiation; ``x`` itself takes no gradient."""
    x = x.detach().requires_grad_(True)
    out = d_fn(x)
    (grads,) = torch.autograd.grad(out, x, torch.ones_like(out), create_graph=True)
    return grads


def wgan_gp_penalty(
    d_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    norm_eps: float = 0.0,
) -> torch.Tensor:
    """mean((|dD/dx_interp| - 1)^2) over samples, x_interp = alpha*real
    + (1-alpha)*fake with one alpha per sample, shape (B, 1, 1, 1): passed
    in, or drawn U[0, 1) from ``generator``. ``norm_eps`` is added to the
    sum of squares inside the square root: cluster_gan's 1e-12
    (``tpugan/ops/penalty.py:42-68``, clustergan.py:95); at 0 the norm is
    ``_safe_sqrt``'s."""
    if alpha is None:
        shape = (real.shape[0],) + (1,) * (real.dim() - 1)
        alpha = torch.rand(shape, generator=generator, device=real.device, dtype=real.dtype)
    grads = _grad_wrt_input(d_fn, alpha * real + (1.0 - alpha) * fake)
    norms = _safe_sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1) + norm_eps)
    return ((norms - 1.0) ** 2).mean()


def dragan_penalty(
    d_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    dp: Optional[DataParallel] = None,
) -> torch.Tensor:
    """DRAGAN's penalty on perturbed real data (``penalty.py:72-93``):
    interp = alpha*X + (1-alpha)*(X + 0.5*std(X)*noise), with ``alpha`` and
    ``noise`` element-wise U[0, 1) of X's shape: passed in, or drawn from
    ``generator`` in that order. std is the population std of all of X
    (ddof 0, ``jnp.std``); under data parallelism (``dp``) X is this rank's
    rows and std that of the global batch (``parallel.mesh.global_std``),
    as ``jnp.std`` of the sharded batch. Kept for parity: the norm of dD/dx is over the
    channel axis only (dim 1 of NCHW), at every position, as the reference's
    ``gradients.norm(2, dim=1)`` without a flatten (dragan.py:166);
    mean((norm - 1)^2) over batch and positions."""
    if alpha is None:
        alpha = torch.rand(real.shape, generator=generator, device=real.device, dtype=real.dtype)
    if noise is None:
        noise = torch.rand(real.shape, generator=generator, device=real.device, dtype=real.dtype)
    perturbed = real + 0.5 * global_std(dp, real) * noise
    grads = _grad_wrt_input(d_fn, alpha * real + (1.0 - alpha) * perturbed)
    norms = _safe_sqrt((grads ** 2).sum(dim=1))
    return ((norms - 1.0) ** 2).mean()


def wdiv_penalty(
    d_fn: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    k: float = 2.0,
    p: float = 6.0,
) -> torch.Tensor:
    """The Wasserstein-divergence penalty (``penalty.py:96-111``):
    mean(|dD/dx_real|^p + |dD/dx_fake|^p) * k / 2, the p-th power taken as
    (sum of squares)^(p/2) per sample, in float32 whatever the gradient's
    dtype (a bf16 fake gives bf16 gradients). No random draw."""
    powers = [
        (_grad_wrt_input(d_fn, x).float().reshape(x.shape[0], -1) ** 2).sum(dim=1) ** (p / 2)
        for x in (real, fake)
    ]
    return (powers[0] + powers[1]).mean() * k / 2.0
