"""Image-space ops on NCHW tensors (``tpugan/ops/image.py`` and the pads of
``tpugan/nn/im2im.py``), as the PyTorch operators the reference uses."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflection_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """nn.ReflectionPad2d(pad)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """nn.Upsample(scale_factor=scale), nearest."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def zero_pad_lt(x: torch.Tensor) -> torch.Tensor:
    """nn.ZeroPad2d((1, 0, 1, 0)): one zero column on the left, one zero row
    on top (the PatchGAN head's asymmetric pad)."""
    return F.pad(x, (1, 0, 1, 0))


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             count_include_pad: bool = True) -> torch.Tensor:
    """nn.AvgPool2d(window, stride, padding, count_include_pad)
    (``tpugan/ops/image.py:avg_pool``)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize to ``out_hw`` (``tpugan/ops/image.py:resize_bilinear``):
    ``jax.image.resize(..., "bilinear")``, which widens its triangle filter by
    the scale when it shrinks (antialiasing), as ``F.interpolate`` does with
    ``antialias=True``; half-pixel centres (``align_corners=False``)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=True)


def resize_bicubic(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize to ``out_hw``: ``jax.image.resize(..., "bicubic")``
    (``tpugan/models/srgan.py:prepare_lr_hr``), Keys' cubic with a = -0.5
    on half-pixel centres, its support widened by the scale when it
    shrinks. ``F.interpolate`` computes that only with ``antialias=True``;
    without it a 4x shrink samples the cubic at the output's centres alone
    (off by up to 0.64 on images in [0, 1])."""
    return F.interpolate(x, size=tuple(out_hw), mode="bicubic", align_corners=False,
                         antialias=True)
