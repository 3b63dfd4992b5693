"""The super-resolution generators and their shared discriminator
(``tpugan/nn/sr.py``), with the reference's ``state_dict`` keys.

srgan/models.py: the SRResNet generator (PReLU residual blocks with
BatchNorm(eps 0.8), two PixelShuffle 2x stages, :18-71) and the 8-conv
discriminator (:74-105). esrgan/models.py: the RRDB generator (dense blocks
over growing concats, 0.2-scaled residuals, no norms, :18-93) and the same
discriminator (:96-127). Every conv keeps torch's default init; the
reference applies no ``weights_init_normal`` here. The dense concat is
``torch.cat``: the JAX package's channel split (``TPUGAN_DENSE_SPLIT``) is a
TPU workaround and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpugan_torch.nn.layers import BatchNorm2d, Conv2d, LeakyReLU, PixelShuffle, PReLU


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          generator: Optional[torch.Generator]) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, padding, init_mode="torch", generator=generator)


class SRResidualBlock(nn.Module):
    """srgan/models.py:18-30: x + (Conv, BN(0.8), PReLU, Conv, BN(0.8))(x)."""

    def __init__(self, features: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_block = nn.Sequential(
            _conv(features, features, 3, 1, 1, generator), BatchNorm2d(features, 0.8), PReLU(),
            _conv(features, features, 3, 1, 1, generator), BatchNorm2d(features, 0.8))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class SRGANGenerator(nn.Module):
    """srgan/models.py:33-71 (SRResNet, 4x): conv1, res_blocks, conv2,
    upsampling (Conv to 256, BN at the default eps, PixelShuffle(2), PReLU,
    twice), conv3 with its Tanh."""

    def __init__(self, channels: int = 3, n_residual_blocks: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Sequential(_conv(channels, 64, 9, 1, 4, generator), PReLU())
        self.res_blocks = nn.Sequential(*[SRResidualBlock(64, generator)
                                          for _ in range(n_residual_blocks)])
        self.conv2 = nn.Sequential(_conv(64, 64, 3, 1, 1, generator), BatchNorm2d(64, 0.8))
        up = []
        for _ in range(2):
            up += [_conv(64, 256, 3, 1, 1, generator), BatchNorm2d(256), PixelShuffle(2), PReLU()]
        self.upsampling = nn.Sequential(*up)
        self.conv3 = nn.Sequential(_conv(64, channels, 9, 1, 4, generator), nn.Tanh())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(x)
        y = out1 + self.conv2(self.res_blocks(out1))
        return self.conv3(self.upsampling(y))


class DenseResidualBlock(nn.Module):
    """esrgan/models.py:18-45: b1..b5, each a 3x3 conv over the concat of the
    input and every earlier output, LeakyReLU(0.01) after all but b5; b5's
    output scaled by 0.2 and added to the input."""

    def __init__(self, filters: int = 64, res_scale: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res_scale = res_scale
        for i in range(1, 6):
            conv = _conv(i * filters, filters, 3, 1, 1, generator)
            self.add_module(f"b{i}", nn.Sequential(conv, LeakyReLU(0.01)) if i < 5
                            else nn.Sequential(conv))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(1, 6):
            out = getattr(self, f"b{i}")(inputs)
            if i < 5:
                inputs = torch.cat([inputs, out], 1)
        return out * self.res_scale + x


class RRDB(nn.Module):
    """esrgan/models.py:48-57 (ResidualInResidualDenseBlock): three dense
    blocks, their output scaled by 0.2 and added to the input."""

    def __init__(self, filters: int = 64, res_scale: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res_scale = res_scale
        self.dense_blocks = nn.Sequential(*[DenseResidualBlock(filters, generator=generator)
                                            for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_blocks(x) * self.res_scale + x


class ESRGANGenerator(nn.Module):
    """esrgan/models.py:60-93 (GeneratorRRDB): conv1, res_blocks of RRDBs,
    conv2 added to conv1's output, upsampling (Conv to 4x filters,
    LeakyReLU(0.01), PixelShuffle(2); convs at indices 0 and 3), conv3."""

    def __init__(self, channels: int = 3, filters: int = 64, num_res_blocks: int = 16,
                 num_upsample: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(channels, filters, 3, 1, 1, generator)
        self.res_blocks = nn.Sequential(*[RRDB(filters, generator=generator)
                                          for _ in range(num_res_blocks)])
        self.conv2 = _conv(filters, filters, 3, 1, 1, generator)
        up = []
        for _ in range(num_upsample):
            up += [_conv(filters, 4 * filters, 3, 1, 1, generator), LeakyReLU(0.01),
                   PixelShuffle(2)]
        self.upsampling = nn.Sequential(*up)
        self.conv3 = nn.Sequential(_conv(filters, filters, 3, 1, 1, generator), LeakyReLU(0.01),
                                   _conv(filters, channels, 3, 1, 1, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(x)
        y = out1 + self.conv2(self.res_blocks(out1))
        return self.conv3(self.upsampling(y))


class SRDiscriminator(nn.Module):
    """srgan/models.py:74-105 = esrgan/models.py:96-127: four blocks of a
    stride-1 and a stride-2 3x3 conv (64, 128, 256, 512), BatchNorm at the
    default eps after each but the first conv, LeakyReLU(0.2); a 3x3 head
    to one channel, raw (a patch of H/16 x W/16)."""

    def __init__(self, channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers, cin = [], channels
        for i, f in enumerate((64, 128, 256, 512)):
            layers.append(_conv(cin, f, 3, 1, 1, generator))
            if i > 0:
                layers.append(BatchNorm2d(f))
            layers += [LeakyReLU(0.2), _conv(f, f, 3, 2, 1, generator), BatchNorm2d(f),
                       LeakyReLU(0.2)]
            cin = f
        layers.append(_conv(cin, 1, 3, 1, 1, generator))
        self.model = nn.Sequential(*layers)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)
