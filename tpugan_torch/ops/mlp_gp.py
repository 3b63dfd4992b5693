"""Closed-form WGAN-GP for the template-A MLP critic: the Hopper kernel pair
and its plain PyTorch version.

Replaces the Pallas TPU kernels of ``tpugan/ops/pallas_critic.py``:
``mlp_gp_pallas`` (:202), ``_gp_fwd_kernel`` (:151) and ``_gp_bwd_kernel``
(:165). For the critic flat image -> N1 -> N2 -> 1 with LeakyReLU(0.2) and
no sigmoid, the input gradient and the penalty's parameter gradients have a
closed form (the docstring of ``pallas_critic.py``, :1-20), so the
double-backward needs no autograd graph. The kernels are
``tpugan_torch/csrc/mlp_gp.cu``: four tiled FP32 products with mask epilogues
in each direction, bound by FP32 FFMA rate.

Layouts are torch's: x is the (B, N0) flattened interpolates in
``img.view(B, -1)`` order, and the weights are ``nn.Linear``'s (out, in):
w1 (N1, N0), w2 (N2, N1), w3 (1, N2). The forward keeps u and t for the
backward, which computes the same function as recomputing them.

Outside the kernels, as in JAX: the per-sample norm and P = mean((|g|-1)^2)
with torch's norm-at-0 subgradient, and q = dP/dg (``_norm_penalty`` :75,
``_q_from`` :84), in plain torch ops.

Dispatch is by device and nothing else: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. ``gp_fwd_launches`` and
``gp_bwd_launches`` count wrapper calls that launched, and only those.
"""

from __future__ import annotations

import torch
from torch import nn

SLOPE = 0.2  # LeakyReLU slope of the critic (wgan/wgan.py:70)

gp_fwd_launches = 0
gp_bwd_launches = 0


def reset_launch_counts() -> None:
    global gp_fwd_launches, gp_bwd_launches
    gp_fwd_launches = 0
    gp_bwd_launches = 0


def _mask(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z.new_tensor(1.0), z.new_tensor(SLOPE))


def mlp_gp_fwd_ref(x, w1, b1, w2, b2, w3, masks=None):
    """Plain version of the forward kernel: (g, m1, m2, u, t). ``masks``
    = (m1, m2) replaces the masks computed from the pre-activations (the
    card's parity check uses it where a pre-activation sits within rounding
    of 0)."""
    z1 = x @ w1.T + b1
    m1 = _mask(z1) if masks is None else masks[0]
    z2 = (z1 * m1) @ w2.T + b2
    m2 = _mask(z2) if masks is None else masks[1]
    u = m2 * w3.reshape(1, -1)
    t = (u @ w2) * m1
    return t @ w1, m1, m2, u, t


def mlp_gp_bwd_ref(q, m1, m2, w1, w2, u, t):
    """Plain version of the backward kernel: (dw1, dw2, dw3) in the weights'
    layouts, dw3 as (1, N2)."""
    s = (q @ w1.T) * m1
    dw1 = t.T @ q
    dw2 = u.T @ s
    dw3 = (m2 * (s @ w2.T)).sum(dim=0, keepdim=True)
    return dw1, dw2, dw3


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device}, expected all on CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input of shape {tuple(t.shape)}")


def _shapes(x, w1, w2):
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 or x.numel() == 0:
        raise ValueError(
            f"mlp_gp: expected x (B, N0), w1 (N1, N0), w2 (N2, N1); got "
            f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}"
        )
    (b, n0), n1, n2 = x.shape, w1.shape[0], w2.shape[0]
    if w1.shape[1] != n0 or w2.shape[1] != n1:
        raise ValueError(f"mlp_gp: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do not chain "
                         f"from x {tuple(x.shape)}")
    return b, n0, n1, n2


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def mlp_gp_fwd(x, w1, b1, w2, b2, w3):
    """Forward wrapper: (g, m1, m2, u, t). CPU tensors take the plain
    version; CUDA tensors launch ``mlp_gp_fwd`` of ``mlp_gp.cu``."""
    global gp_fwd_launches
    if x.device.type == "cpu":
        return mlp_gp_fwd_ref(x, w1, b1, w2, b2, w3)
    _check_cuda("mlp_gp_fwd", x, w1, b1, w2, b2, w3)
    b, n0, n1, n2 = _shapes(x, w1, w2)
    if b1.shape != (n1,) or b2.shape != (n2,) or w3.numel() != n2:
        raise ValueError(f"mlp_gp_fwd: b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}, "
                         f"w3 {tuple(w3.shape)} do not fit N1 {n1}, N2 {n2}")
    from tpugan_torch.ops._build import library

    new = lambda *shape: torch.empty(shape, device=x.device, dtype=torch.float32)
    g, m1, m2, u, t, a1 = new(b, n0), new(b, n1), new(b, n2), new(b, n2), new(b, n1), new(b, n1)
    rc = library().mlp_gp_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
        g.data_ptr(), m1.data_ptr(), m2.data_ptr(), u.data_ptr(), t.data_ptr(), a1.data_ptr(),
        b, n0, n1, n2, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "mlp_gp_fwd")
    gp_fwd_launches += 1
    return g, m1, m2, u, t


def mlp_gp_bwd(q, m1, m2, w1, w2, u, t):
    """Backward wrapper: (dw1, dw2, dw3). CPU tensors take the plain
    version; CUDA tensors launch ``mlp_gp_bwd`` of ``mlp_gp.cu``."""
    global gp_bwd_launches
    if q.device.type == "cpu":
        return mlp_gp_bwd_ref(q, m1, m2, w1, w2, u, t)
    _check_cuda("mlp_gp_bwd", q, m1, m2, w1, w2, u, t)
    b, n0, n1, n2 = _shapes(q, w1, w2)
    if m1.shape != (b, n1) or t.shape != (b, n1) or m2.shape != (b, n2) or u.shape != (b, n2):
        raise ValueError(
            f"mlp_gp_bwd: m1 {tuple(m1.shape)}, t {tuple(t.shape)}, m2 {tuple(m2.shape)}, "
            f"u {tuple(u.shape)} do not fit B {b}, N1 {n1}, N2 {n2}"
        )
    from tpugan_torch.ops._build import library

    new = lambda *shape: torch.empty(shape, device=q.device, dtype=torch.float32)
    dw1, dw2, dw3, s = new(n1, n0), new(n2, n1), new(1, n2), new(b, n1)
    rc = library().mlp_gp_bwd(
        q.data_ptr(), m1.data_ptr(), m2.data_ptr(), w1.data_ptr(), w2.data_ptr(), u.data_ptr(),
        t.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dw3.data_ptr(), s.data_ptr(),
        b, n0, n1, n2, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "mlp_gp_bwd")
    gp_bwd_launches += 1
    return dw1, dw2, dw3


def norm_penalty(g: torch.Tensor):
    """(mean((|g| - 1)^2), |g|) per row, with the norm's subgradient 0 at 0
    (``pallas_critic.py:_norm_penalty``)."""
    sq = (g * g).sum(dim=1)
    nonzero = sq > 0
    n = torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)
    return ((n - 1.0) ** 2).mean(), n


def q_from(g: torch.Tensor, n: torch.Tensor, ct) -> torch.Tensor:
    """dP/dg times the upstream cotangent: (2/B)(n-1)/n * g, 0 where n = 0
    (``pallas_critic.py:_q_from``)."""
    nonzero = n > 0
    coef = torch.where(nonzero, (n - 1.0) / torch.where(nonzero, n, 1.0), 0.0)
    return (ct * 2.0 / g.shape[0]) * coef[:, None] * g


class MLPGradPenalty(torch.autograd.Function):
    """P = mean((|dD/dx| - 1)^2) of the template-A critic at x, with the
    kernel pair as forward and backward. Gradients flow to w1, w2 and w3
    only: those of x, b1 and b2 are exactly 0, and are returned as None."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3):
        g, m1, m2, u, t = mlp_gp_fwd(x, w1, b1, w2, b2, w3)
        p, n = norm_penalty(g)
        ctx.save_for_backward(g, n, m1, m2, w1, w2, u, t)
        ctx.w3_shape = w3.shape
        return p

    @staticmethod
    def backward(ctx, ct):
        g, n, m1, m2, w1, w2, u, t = ctx.saved_tensors
        q = q_from(g, n, ct).contiguous()
        dw1, dw2, dw3 = mlp_gp_bwd(q, m1, m2, w1, w2, u, t)
        return None, dw1, None, dw2, None, dw3.reshape(ctx.w3_shape)


def mlp_grad_penalty(x, w1, b1, w2, b2, w3) -> torch.Tensor:
    return MLPGradPenalty.apply(x, w1, b1, w2, b2, w3)


def extract_mlp_critic(module: nn.Module):
    """(w1, b1, w2, b2, w3) when ``module`` is exactly the template-A critic
    (``MLPDiscriminator(sigmoid=False)`` with two hidden layers and float32
    parameters), else None (``pallas_critic.py:57-72``). b3 is left out: the
    penalty does not depend on it."""
    from tpugan_torch.nn.blocks import MLPDiscriminator

    if type(module) is not MLPDiscriminator or module.sigmoid or len(module.model) != 5:
        return None
    l1, l2, l3 = module.model[0], module.model[2], module.model[4]
    params = (l1.weight, l1.bias, l2.weight, l2.bias, l3.weight)
    if any(p.dtype != torch.float32 for p in params):
        return None
    return params
