"""Adaptive instance norm (AdaIN): the Hopper kernel pair and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``adain_pallas`` of
``tpugan/ops/pallas_kernels.py`` (:412; ``_adain_fwd_kernel`` :343,
``_adain_bwd_kernel`` :354): instance norm over each (sample, channel) plane,
then ``y = xh * w[b, c] + bias[b, c]`` with w and bias of shape (B, C)
predicted from a style code (munit/models.py:268-301). The kernels are the
affine variant of the instance-norm pair in
``tpugan_torch/csrc/instance_norm.cu`` (``adain_fwd``/``adain_bwd``): one
thread block per plane of contiguous NCHW float32, bound by memory bandwidth.
The backward gives dx, dw = sum(g * xh) and dbias = sum(g) per plane, with w
outside the bracket of dx, so w = 0 needs no special case.

Dispatch is by device and nothing else: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. ``adain_fwd_launches`` and
``adain_bwd_launches`` count kernel launches, and only those.
"""

from __future__ import annotations

import torch

from tpugan_torch.ops.instance_norm import _launch_bwd, _launch_fwd, _planes

adain_fwd_launches = 0
adain_bwd_launches = 0


def reset_launch_counts() -> None:
    global adain_fwd_launches, adain_bwd_launches
    adain_fwd_launches = 0
    adain_bwd_launches = 0


def adain_fwd_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """Plain version of the forward kernel: (y, mean, rstd), the statistics
    of shape (B*C,). The variance is centred (two passes), as ``jnp.var``."""
    planes, hw = _planes(x)
    x2 = x.reshape(planes, hw)
    mean = x2.mean(dim=1)
    xc = x2 - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=1) + eps)
    y = xc * rstd[:, None] * w.reshape(planes, 1) + b.reshape(planes, 1)
    return y.reshape(x.shape), mean, rstd


def adain_bwd_ref(g, x, w, mean, rstd):
    """Plain version of the backward kernel: (dx, dw, dbias), dw and dbias
    of shape (B, C)."""
    planes, hw = _planes(x)
    xh = (x.reshape(planes, hw) - mean[:, None]) * rstd[:, None]
    g2 = g.reshape(planes, hw)
    s = g2.sum(dim=1)
    t = (g2 * xh).sum(dim=1)
    scale = w.reshape(planes) * rstd
    dx = (g2 - (s / hw)[:, None] - xh * (t / hw)[:, None]) * scale[:, None]
    return dx.reshape(x.shape), t.reshape(w.shape), s.reshape(w.shape)


def adain_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """Forward wrapper: (y, mean, rstd). CPU tensors take the plain version;
    CUDA tensors launch ``adain_fwd`` of ``instance_norm.cu``."""
    global adain_fwd_launches
    if x.device.type == "cpu":
        return adain_fwd_ref(x, w, b, eps)
    out = _launch_fwd("adain_fwd", x, eps, 1.0, w, b)
    adain_fwd_launches += 1
    return out


def adain_bwd(g, x, w, mean, rstd):
    """Backward wrapper: (dx, dw, dbias). CPU tensors take the plain
    version; CUDA tensors launch ``adain_bwd`` of ``instance_norm.cu``."""
    global adain_bwd_launches
    if x.device.type == "cpu":
        return adain_bwd_ref(g, x, w, mean, rstd)
    out = _launch_bwd("adain_bwd", g, x, mean, rstd, 1.0, w)
    adain_bwd_launches += 1
    return out


class AdaIN(torch.autograd.Function):
    """AdaIN with the kernel pair as forward and backward. Saves x, w, mean
    and rstd, as the Pallas VJP keeps its residuals. w and bias may be
    strided slices of a wider tensor (the style MLP's output): the kernels
    get contiguous copies, and dw and dbias come back as (B, C) for autograd
    to route into the slices."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        w = weight.contiguous()
        y, mean, rstd = adain_fwd(x, w, bias.contiguous(), eps)
        ctx.save_for_backward(x, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, mean, rstd = ctx.saved_tensors
        dx, dw, db = adain_bwd(g.contiguous(), x, w, mean, rstd)
        return dx, dw, db, None


def adain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          eps: float = 1e-5) -> torch.Tensor:
    """AdaptiveInstanceNorm2d (``tpugan/nn/style.py:adain``) on NCHW:
    instance norm with the biased variance, then scale by ``weight`` and
    shift by ``bias``, both (B, C)."""
    return AdaIN.apply(x, weight, bias, eps)
