"""MUNIT's networks (``tpugan/nn/style.py``) on NCHW: the AdaIN residual
decoder with its style MLP, the content and style encoders, and the
three-scale MultiDiscriminator.

Layers are registered in flax call order, so
``tpugan_torch.io.interop.load_jax_params`` pairs them in order, and under
the reference's ``state_dict`` names (munit/models.py): ``model.<i>`` indexed
as the reference's ``nn.Sequential``, ``mlp.model.<i>``,
``models.disc_<k>.<i>``. A fused IN+activation entry stands for two
reference entries. The AdaIN blocks keep only their convs (``block.1``,
``block.5``): their affine comes from the style MLP at each call, and the
reference's unused running-stat buffers are not carried.

Every AdaIN goes through ``tpugan_torch.ops.adain`` (the CUDA pair on the
card), every instance norm through ``tpugan_torch.ops.instance_norm``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import mse
from tpugan_torch.nn.im2im import ResidualBlockIN, _numbered
from tpugan_torch.nn.layers import (
    Conv2d,
    InstanceNorm,
    LayerNormSpatial,
    LeakyReLU,
    Linear,
    ReflectionPad,
    Upsample,
)
from tpugan_torch.ops.adain import adain
from tpugan_torch.ops.image import avg_pool, reflection_pad

# The reference's weights_init_normal: conv and linear weights N(0, 0.02),
# biases at torch's default (tpugan/nn/style.py's init_mode="normal02").
INIT = "normal02"
MLP_DIM, MLP_BLOCKS = 256, 3  # munit/models.py:179
D_FILTERS, D_TOWERS = (64, 128, 256, 512), 3  # munit/models.py:197-235


class AdaINResidualBlock(nn.Module):
    """munit/models.py:243-260 with norm="adain": pad-conv3-AdaIN-ReLU-
    pad-conv3-AdaIN with an identity skip. ``params`` is (B, 4*C) as
    [bias1, weight1, bias2, weight2], the reference's assignment order
    (models.py:87-99)."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        conv = lambda: Conv2d(features, features, 3, init_mode=INIT, generator=generator)
        self.block = nn.Sequential(OrderedDict([("1", conv()), ("5", conv())]))

    def forward(self, x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        c = self.features
        b1, w1, b2, w2 = (params[:, i * c:(i + 1) * c] for i in range(4))
        y = torch.relu(adain(self.block[0](reflection_pad(x, 1)), w1, b1))
        y = adain(self.block[1](reflection_pad(y, 1)), w2, b2)
        return x + y


class ContentEncoder(nn.Module):
    """munit/models.py:113-141: c7s1, stride-2 downs, IN residual blocks.
    The head and down IN sites are plain IN followed by ``nn.ReLU`` (its
    gradient at 0 is 0, as ``nn.relu`` in JAX); the residual blocks fuse
    IN+ReLU as the JAX block does."""

    def __init__(self, in_channels: int = 3, dim: int = 64, n_residual: int = 3,
                 n_downsample: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = lambda *a: Conv2d(*a, init_mode=INIT, generator=generator)
        layers = [(ReflectionPad(3), 1), (conv(in_channels, dim, 7), 1),
                  (InstanceNorm(), 1), (nn.ReLU(), 1)]
        for _ in range(n_downsample):
            layers += [(conv(dim, dim * 2, 4, 2, 1), 1), (InstanceNorm(), 1), (nn.ReLU(), 1)]
            dim *= 2
        layers += [(ResidualBlockIN(dim, generator, INIT), 1) for _ in range(n_residual)]
        self.model = _numbered(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class StyleEncoder(nn.Module):
    """munit/models.py:149-171: no norms; AdaptiveAvgPool(1) and a 1x1 conv
    to (B, style_dim)."""

    def __init__(self, in_channels: int = 3, dim: int = 64, n_downsample: int = 2,
                 style_dim: int = 8, generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = lambda *a: Conv2d(*a, init_mode=INIT, generator=generator)
        layers = [ReflectionPad(3), conv(in_channels, dim, 7), nn.ReLU()]
        for _ in range(2):
            layers += [conv(dim, dim * 2, 4, 2, 1), nn.ReLU()]
            dim *= 2
        for _ in range(n_downsample - 2):
            layers += [conv(dim, dim, 4, 2, 1), nn.ReLU()]
        layers += [nn.AdaptiveAvgPool2d(1), conv(dim, style_dim, 1, 1, 0)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x).reshape(x.shape[0], -1)


class StyleMLP(nn.Module):
    """munit/models.py:179-189: style code -> AdaIN parameters."""

    def __init__(self, input_dim: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        linear = lambda i, o: Linear(i, o, init_mode=INIT, generator=generator)
        layers = [linear(input_dim, MLP_DIM), nn.ReLU()]
        for _ in range(MLP_BLOCKS - 2):
            layers += [linear(MLP_DIM, MLP_DIM), nn.ReLU()]
        layers.append(linear(MLP_DIM, output_dim))
        self.model = nn.Sequential(*layers)

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        return self.model(style.reshape(style.shape[0], -1))


class MunitDecoder(nn.Module):
    """munit/models.py:50-105: AdaIN residual blocks, (Upsample, conv5,
    LayerNorm, ReLU) ups and a c7s1 tanh output; the style MLP predicts every
    AdaIN's weight and bias, 4*C a block."""

    def __init__(self, out_channels: int = 3, dim: int = 64, n_residual: int = 3,
                 n_upsample: int = 2, style_dim: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = dim * 2 ** n_upsample
        self.features, self.n_residual = d, n_residual
        conv = lambda *a: Conv2d(*a, init_mode=INIT, generator=generator)
        layers = [(AdaINResidualBlock(d, generator), 1) for _ in range(n_residual)]
        for _ in range(n_upsample):
            layers += [(Upsample(2), 1), (conv(d, d // 2, 5, 1, 2), 1),
                       (LayerNormSpatial(d // 2, generator=generator), 1), (nn.ReLU(), 1)]
            d //= 2
        layers += [(ReflectionPad(3), 1), (conv(d, out_channels, 7), 1), (nn.Tanh(), 1)]
        self.model = _numbered(layers)
        self.mlp = StyleMLP(style_dim, 4 * self.features * n_residual, generator=generator)

    def forward(self, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        params = self.mlp(style)
        width = 4 * self.features
        y = content
        for i, layer in enumerate(self.model):
            if i < self.n_residual:
                y = layer(y, params[:, i * width:(i + 1) * width])
            else:
                y = layer(y)
        return y


class MultiDiscriminator(nn.Module):
    """munit/models.py:197-235: three PatchGAN towers, each on the input
    AvgPool(3, s2, p1, count_include_pad=False)-downsampled once more than
    the last. Returns the list of tower outputs."""

    def __init__(self, in_channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = lambda *a: Conv2d(*a, init_mode=INIT, generator=generator)
        self.models = nn.ModuleList()
        for k in range(D_TOWERS):
            layers, cin = [], in_channels
            for i, f in enumerate(D_FILTERS):
                layers.append((conv(cin, f, 4, 2, 1), 1))
                layers.append((LeakyReLU(0.2), 1) if i == 0 else (InstanceNorm(act_slope=0.2), 2))
                cin = f
            layers.append((conv(cin, 1, 3, 1, 1), 1))
            self.models.add_module("disc_%d" % k, _numbered(layers))

    def forward(self, x: torch.Tensor) -> list:
        outputs = []
        for k, tower in enumerate(self.models):
            if k:
                x = avg_pool(x, 3, 2, 1, count_include_pad=False)
            outputs.append(tower(x))
        return outputs


def multi_d_loss(outputs, gt: float) -> torch.Tensor:
    """MultiDiscriminator.compute_loss (munit/models.py:225-228): the sum of
    the towers' MSEs against a scalar target."""
    return sum(mse(out, gt) for out in outputs)
