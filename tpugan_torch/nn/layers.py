"""Layers with the JAX package's semantics (``tpugan/nn/layers.py``), on NCHW.

Only what the CycleGAN, WGAN-GP and MUNIT slices need is here. Options they
do not use raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
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


def _check_init_mode(layer: str, init_mode: str, ported: tuple) -> None:
    if init_mode not in ported:
        raise NotImplementedError(f"{layer}(init_mode={init_mode!r}): {_LAYERS_ITEM}")


@torch.no_grad()
def _init_weight_bias(layer, init_mode: str, fan_in: int, generator) -> None:
    """``tpugan/nn/layers.py:_weight_init``/``_bias_init``: ``torch`` is
    kaiming_uniform_(a=sqrt(5)) and bias U(+-1/sqrt(fan_in)); ``normal02``
    is weight N(0, 0.02) with that same bias (the reference's
    ``weights_init_normal``, which leaves biases at torch's default);
    ``normal02zero`` is weight N(0, 0.02) and bias zero. Draws come from
    ``generator``, so a seed fixes them."""
    if init_mode == "torch":
        nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=generator)
    else:
        layer.weight.normal_(0.0, 0.02, generator=generator)
    if layer.bias is None:
        return
    if init_mode == "normal02zero":
        layer.bias.zero_()
    else:
        bound = 1.0 / math.sqrt(fan_in)
        layer.bias.uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Conv2d):
    """torch.nn.Conv2d with an ``init_mode`` of ``tpugan/nn/layers.py:Conv``.
    The default is ``normal02zero``, the reference cyclegan's
    ``weights_init_normal`` (cyclegan/models.py:6-14); munit's is
    ``normal02``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
        *,
        init_mode: str = "normal02zero",
        generator: Optional[torch.Generator] = None,
    ):
        _check_init_mode("Conv2d", init_mode, ("normal02zero", "normal02"))
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        _init_weight_bias(self, init_mode, in_channels * kernel_size * kernel_size, generator)


class Linear(nn.Linear):
    """torch.nn.Linear with an ``init_mode`` of ``tpugan/nn/layers.py:Linear``;
    the default is torch's own init."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        init_mode: str = "torch",
        generator: Optional[torch.Generator] = None,
    ):
        _check_init_mode("Linear", init_mode, ("torch", "normal02"))
        super().__init__(in_features, out_features, bias=bias)
        _init_weight_bias(self, init_mode, in_features, generator)


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


class LayerNormSpatial(nn.Module):
    """MUNIT's LayerNorm (``tpugan/nn/layers.py:LayerNormSpatial``,
    munit/models.py:304-324): per sample over (C, H, W), divided by the
    unbiased std plus eps (eps on the std, not the variance), then a
    per-channel affine ``gamma`` ~ U(0, 1), ``beta`` = 0, registered under
    the reference's names."""

    eps = 1e-5

    def __init__(self, num_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(num_features).uniform_(generator=generator))
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        mean = flat.mean(dim=1).reshape(-1, 1, 1, 1)
        std = flat.std(dim=1).reshape(-1, 1, 1, 1)
        y = (x - mean) / (std + self.eps)
        return y * self.gamma.reshape(1, -1, 1, 1) + self.beta.reshape(1, -1, 1, 1)


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
