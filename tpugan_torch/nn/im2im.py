"""The CycleGAN networks of ``tpugan/nn/im2im.py``: ResNet generator and
PatchGAN discriminator, on NCHW.

Layers are registered in call order, which is the flax insertion order of
the JAX modules, so ``tpugan_torch.io.interop.load_jax_params`` pairs them
in order. Each ``nn.Sequential`` entry is named by its index in the
reference's own ``nn.Sequential`` (cyclegan/models.py:22-122), so a
``state_dict`` carries the reference's keys. A fused IN+activation entry
stands for two reference entries and the next index skips one.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from tpugan_torch.nn.layers import (
    Conv2d,
    InstanceNorm,
    LeakyReLU,
    ReflectionPad,
    Upsample,
    ZeroPadLT,
)


def _numbered(layers) -> nn.Sequential:
    """nn.Sequential from (module, n_reference_entries) pairs, each named by
    the reference index of its first entry."""
    named, i = OrderedDict(), 0
    for module, width in layers:
        named[str(i)] = module
        i += width
    return nn.Sequential(named)


class ResidualBlockIN(nn.Module):
    """ReflectionPad(1)-Conv3-IN-ReLU-ReflectionPad(1)-Conv3-IN with an
    identity skip (``tpugan/nn/im2im.py:157-181``). IN+ReLU is fused, as the
    JAX block's ``instance_norm_act(y, 0.0)``: its gradient at exactly 0 is
    1."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None,
                 init_mode: str = "normal02zero"):
        super().__init__()
        conv = lambda: Conv2d(features, features, 3, init_mode=init_mode, generator=generator)
        self.block = _numbered([
            (ReflectionPad(1), 1), (conv(), 1), (InstanceNorm(act_slope=0.0), 2),
            (ReflectionPad(1), 1), (conv(), 1), (InstanceNorm(), 1),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class GeneratorResNet(nn.Module):
    """c7s1-64, two stride-2 downs, N residual blocks, two (Upsample + conv)
    ups, c7s1-C and tanh (``tpugan/nn/im2im.py:184-276``). The reflection
    pads at both ends are of size ``channels``: the reference passes the
    channel count as the pad, a quirk kept as it is."""

    def __init__(
        self,
        channels: int,
        num_residual_blocks: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        layers = [
            (ReflectionPad(channels), 1),
            (Conv2d(channels, 64, 7, generator=g), 1),
            (InstanceNorm(act_slope=0.0), 2),
        ]
        feats = 64
        for _ in range(2):
            layers += [
                (Conv2d(feats, feats * 2, 3, 2, 1, generator=g), 1),
                (InstanceNorm(act_slope=0.0), 2),
            ]
            feats *= 2
        layers += [(ResidualBlockIN(feats, g), 1) for _ in range(num_residual_blocks)]
        for _ in range(2):
            layers += [
                (Upsample(2), 1),
                (Conv2d(feats, feats // 2, 3, 1, 1, generator=g), 1),
                (InstanceNorm(act_slope=0.0), 2),
            ]
            feats //= 2
        layers += [
            (ReflectionPad(channels), 1),
            (Conv2d(feats, channels, 7, generator=g), 1),
            (nn.Tanh(), 1),
        ]
        self.model = _numbered(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class PatchGAN(nn.Module):
    """Four stride-2 conv blocks (IN + LeakyReLU(0.2) after all but the
    first), ZeroPad2d((1, 0, 1, 0)) and a 4x4 head
    (``tpugan/nn/im2im.py:279-323``; cyclegan's ``head_bias=True``)."""

    def __init__(
        self,
        in_channels: int = 3,
        head_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        layers, cin = [], in_channels
        for i, f in enumerate((64, 128, 256, 512)):
            layers.append((Conv2d(cin, f, 4, 2, 1, generator=generator), 1))
            if i == 0:
                layers.append((LeakyReLU(0.2), 1))
            else:
                layers.append((InstanceNorm(act_slope=0.2), 2))
            cin = f
        layers += [
            (ZeroPadLT(), 1),
            (Conv2d(cin, 1, 4, 1, 1, bias=head_bias, generator=generator), 1),
        ]
        self.model = _numbered(layers)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)
