"""Layers with the JAX package's semantics (``tpugan/nn/layers.py``), on NCHW.

Only what the CycleGAN and WGAN-GP slices need is here. Options they do not
use raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpugan_torch.ops.image import reflection_pad, upsample_nearest, zero_pad_lt
from tpugan_torch.ops.instance_norm import instance_norm_act

_LAYERS_ITEM = "ROADMAP queue 1, item 1 (DCGAN spine: layers)"


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)``: the gradient at exactly 0 is 1, as in
    JAX (``F.leaky_relu`` gives ``slope`` there)."""
    return torch.where(x >= 0, x, negative_slope * x)


class Conv2d(nn.Conv2d):
    """torch.nn.Conv2d with the ``normal02zero`` init of
    ``tpugan/nn/layers.py:_weight_init``: weights N(0, 0.02), bias zero (the
    reference cyclegan's ``weights_init_normal``, cyclegan/models.py:6-14).
    Draws come from ``generator``, so a seed fixes the weights. The other
    init modes come with the DCGAN spine (ROADMAP queue 1, item 1)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class Linear(nn.Linear):
    """torch.nn.Linear with torch's default init (``init_mode="torch"`` of
    ``tpugan/nn/layers.py:Linear``): weight ``kaiming_uniform_(a=sqrt(5))``,
    bias U(+-1/sqrt(fan_in)), both drawn from ``generator`` so a seed fixes
    them. The other init modes come with the DCGAN spine."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        init_mode: str = "torch",
        generator: Optional[torch.Generator] = None,
    ):
        if init_mode != "torch":
            raise NotImplementedError(f"Linear(init_mode={init_mode!r}): {_LAYERS_ITEM}")
        super().__init__(in_features, out_features, bias=bias)
        with torch.no_grad():
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5), generator=generator)
            if self.bias is not None:
                bound = 1.0 / math.sqrt(in_features)
                self.bias.uniform_(-bound, bound, generator=generator)


class BatchNorm1d(nn.BatchNorm1d):
    """torch.nn.BatchNorm1d, the semantics ``tpugan/nn/layers.py:BatchNorm``
    reproduces in flax: ``eps`` passed verbatim (the reference's 0.8),
    momentum 0.1, the biased batch variance to normalize and the unbiased
    one folded into ``running_var``. Scale 1, bias 0 (``init_mode="torch"``);
    the other init modes come with the DCGAN spine."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 *, init_mode: str = "torch"):
        if init_mode != "torch":
            raise NotImplementedError(f"BatchNorm1d(init_mode={init_mode!r}): {_LAYERS_ITEM}")
        super().__init__(num_features, eps=eps, momentum=momentum)


class InstanceNorm(nn.Module):
    """torch.nn.InstanceNorm2d (affine=False) with an optional fused leaky
    activation: ``act_slope`` 1.0 is plain IN, 0.0 IN+ReLU, 0.2
    IN+LeakyReLU(0.2). Runs through the instance-norm kernel pair
    (``tpugan_torch/ops/instance_norm.py``)."""

    def __init__(
        self,
        act_slope: float = 1.0,
        eps: float = 1e-5,
        affine: bool = False,
        track_running_stats: bool = False,
    ):
        super().__init__()
        if affine or track_running_stats:
            raise NotImplementedError(
                f"InstanceNorm(affine={affine}, track_running_stats="
                f"{track_running_stats}): {_LAYERS_ITEM}"
            )
        self.act_slope = act_slope
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm_act(x, self.act_slope, self.eps)

    def extra_repr(self) -> str:
        return f"act_slope={self.act_slope}, eps={self.eps}"


class Upsample(nn.Module):
    """torch.nn.Upsample(scale_factor), nearest."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, self.scale_factor)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


class ReflectionPad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflection_pad(x, self.pad)


class ZeroPadLT(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return zero_pad_lt(x)
