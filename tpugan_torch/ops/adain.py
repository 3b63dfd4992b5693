"""Adaptive instance norm (AdaIN): the Hopper kernel pair and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``adain_pallas`` of
``tpugan/ops/pallas_kernels.py`` (:412; ``_adain_fwd_kernel`` :343,
``_adain_bwd_kernel`` :354): instance norm over each (sample, channel) plane,
then ``y = xh * w[b, c] + bias[b, c]`` with w and bias of shape (B, C)
predicted from a style code (munit/models.py:268-301). The kernels are the
affine variant (``kAffine``) of the instance-norm pair in
``tpugan_torch/csrc/instance_norm.cu``, on contiguous NCHW float32 or
bfloat16 (MUNIT under ``--dtype bfloat16``, where x comes from a bf16
convolution and w and bias from the bf16 style MLP), with the
same launch plan (``instance_norm.plan``): a warp a plane up to 16x16 planes,
else each CTA's slice of the plane held in shared memory, on a thread block
cluster of 2, 4 or 8 CTAs where a plane exceeds one CTA's 64 KB. Bound by
memory bandwidth: 8 bytes an element forward and 12 backward (4 and 6 in
bf16), each input read once. The backward gives dx, dw = sum(g * xh) and
dbias = sum(g) per plane, with w outside the bracket of dx, so w = 0 needs
no special case. The kernels read w and bias in x's dtype where they lie:
(B, C) views whose rows may lie any stride apart, as the column slices of
the style MLP's (B, 4C x blocks) output that MUNIT hands them
(``instance_norm.per_plane_strides`` says what is taken), and write dw and
dbias as contiguous (B, C) tensors in that dtype, each rounded once from its
float32 sum. Nothing is converted or copied around a call: one launch each
way, in float32 and in bf16.

Dispatch is by device and dtype: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel of x's dtype or raises (a mixed call, bf16
with float32, included). The counters ``adain.fwd`` and ``adain.bwd`` of
``tpugan_torch.utils.tracing.counts`` count float32 kernel launches, and
only those, ``adain.fwd.bf16`` and ``adain.bwd.bf16`` bf16 ones.
"""

from __future__ import annotations

import torch

from tpugan_torch.ops.instance_norm import _launch_bwd, _launch_fwd, _planes
from tpugan_torch.utils import tracing


def adain_fwd_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """Plain version of the forward kernel: (y, mean, rstd), the statistics
    of shape (B*C,). The variance is centred (two passes), as ``jnp.var``.
    bf16 inputs are widened to float32, and y is rounded to x's dtype once."""
    if torch.bfloat16 in (x.dtype, w.dtype):
        y, mean, rstd = adain_fwd_ref(x.float(), w.float(), b.float(), eps)
        return y.to(x.dtype), mean, rstd
    planes, hw = _planes(x)
    x2 = x.reshape(planes, hw)
    mean = x2.mean(dim=1)
    xc = x2 - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=1) + eps)
    y = xc * rstd[:, None] * w.reshape(planes, 1) + b.reshape(planes, 1)
    return y.reshape(x.shape), mean, rstd


def adain_bwd_ref(g, x, w, mean, rstd):
    """Plain version of the backward kernel: (dx, dw, dbias), dw and dbias
    of shape (B, C). bf16 inputs are widened to float32; dx is rounded to
    x's dtype once, dw and dbias to w's."""
    if torch.bfloat16 in (x.dtype, w.dtype):
        dx, dw, db = adain_bwd_ref(g.float(), x.float(), w.float(), mean, rstd)
        return dx.to(x.dtype), dw.to(w.dtype), db.to(w.dtype)
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
    CUDA tensors launch the affine forward of ``instance_norm.cu`` for x's
    dtype, which reads w and b in place."""
    if x.is_cpu:
        return adain_fwd_ref(x, w, b, eps)
    out = _launch_fwd("adain_fwd", x, eps, 1.0, w, b)
    tracing.count("adain.fwd.bf16" if x.dtype is torch.bfloat16 else "adain.fwd")
    return out


def adain_bwd(g, x, w, mean, rstd):
    """Backward wrapper: (dx, dw, dbias). CPU tensors take the plain
    version; CUDA tensors launch the affine backward of ``instance_norm.cu``
    for x's dtype, which reads w in place and writes dw and dbias as
    contiguous (B, C) tensors in w's dtype."""
    if x.is_cpu:
        return adain_bwd_ref(g, x, w, mean, rstd)
    out = _launch_bwd("adain_bwd", g, x, mean, rstd, 1.0, w)
    tracing.count("adain.bwd.bf16" if x.dtype is torch.bfloat16 else "adain.bwd")
    return out


class AdaIN(torch.autograd.Function):
    """AdaIN with the kernel pair as forward and backward. Saves x, w, mean
    and rstd, as the Pallas VJP keeps its residuals. w and bias may be
    column slices of a wider tensor (the style MLP's output): the kernels
    read them in place, w is saved as that view (no copy), and dw and dbias
    come back as contiguous (B, C) for autograd to route into the slices."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        y, mean, rstd = adain_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
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
