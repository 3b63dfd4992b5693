"""Templates A and B of ``tpugan/nn/blocks.py``, on NCHW images: the MLP
generator and discriminator / critic, and the DCGAN generator, trunk and
discriminator, and the trunk with the aux heads of acgan, sgan and infogan.

All keep the reference's module names and ``nn.Sequential`` numbering
(gan/gan.py:38-81, dcgan/dcgan.py:45-99), so their ``state_dict`` keys are the
reference's. ``img.view(B, -1)`` and ``flat.view(B, C, H, W)`` are torch's
own orders; ``flatten_nchw`` and ``unflatten_nchw`` reproduce them on the JAX
side, so every Linear's weight lines up with a plain transpose of the flax
kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from tpugan_torch.nn.layers import (
    BatchNorm1d,
    BatchNorm2d,
    Conv2d,
    Dropout2d,
    LeakyReLU,
    Linear,
    MaskedDropout,
    Upsample,
)


def forward_masked(layers: nn.Sequential, x: torch.Tensor,
                   masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """``layers`` applied in order, each dropout layer with the next of
    ``masks`` (in call order; None outside training)."""
    masks = iter(masks) if masks is not None else None
    for layer in layers:
        if isinstance(layer, MaskedDropout) and masks is not None:
            x = layer(x, next(masks))
        else:
            x = layer(x)
    return x


def mlp_generator_body(in_features: int, out_features: int,
                       widths: Sequence[int] = (128, 256, 512, 1024), bn_eps: float = 0.8,
                       *, generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """The reference's ``model`` of template A (gan/gan.py:38-57,
    cgan/cgan.py:43-60): Linear -> [BatchNorm1d(eps=0.8)] -> LeakyReLU(0.2)
    through ``widths`` (no norm on the first block), a Linear to
    ``out_features``, Tanh."""
    layers = []
    fan_in = in_features
    for i, w in enumerate(widths):
        layers.append(Linear(fan_in, w, generator=generator))
        if i > 0:
            layers.append(BatchNorm1d(w, bn_eps))
        layers.append(LeakyReLU(0.2))
        fan_in = w
    layers += [Linear(fan_in, out_features, generator=generator), nn.Tanh()]
    return nn.Sequential(*layers)


class MLPGenerator(nn.Module):
    """Template A generator (``tpugan/nn/blocks.py:32-57``): the
    ``mlp_generator_body`` from ``latent_dim`` to C*H*W, then
    ``view(B, C, H, W)``."""

    def __init__(
        self,
        img_shape: Tuple[int, int, int],
        latent_dim: int,
        widths: Sequence[int] = (128, 256, 512, 1024),
        bn_eps: float = 0.8,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.img_shape = tuple(img_shape)  # (C, H, W)
        self.model = mlp_generator_body(latent_dim, math.prod(self.img_shape), widths, bn_eps,
                                        generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z).view(z.shape[0], *self.img_shape)


class MLPDiscriminator(nn.Module):
    """Template A discriminator (``tpugan/nn/blocks.py:60-77``):
    ``img.view(B, -1)`` -> 512 -> 256 -> 1 with LeakyReLU(0.2);
    ``sigmoid=False`` is the WGAN critic (wgan/wgan.py:65-80)."""

    def __init__(
        self,
        in_features: int,
        widths: Sequence[int] = (512, 256),
        sigmoid: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.sigmoid = sigmoid
        layers = []
        fan_in = in_features
        for w in widths:
            layers += [Linear(fan_in, w, generator=generator), LeakyReLU(0.2)]
            fan_in = w
        layers.append(Linear(fan_in, 1, generator=generator))
        if sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img.reshape(img.shape[0], -1))


class DCGANGenerator(nn.Module):
    """Template B generator (``tpugan/nn/blocks.py:DCGANGenerator``,
    dcgan/dcgan.py:45-71): ``l1`` = Linear(latent -> 128 * (s/4)^2), viewed
    as (B, 128, s/4, s/4), then ``conv_blocks`` = [BatchNorm2d(128), Up,
    Conv3x3(128), BN(128, 0.8), LReLU, Up, Conv3x3(64), BN(64, 0.8), LReLU,
    Conv3x3(channels), Tanh]. ``first_bn=False`` drops the first BatchNorm
    (lsgan/lsgan.py:52-70). The convs and BatchNorms take ``init_mode``: the
    reference's ``weights_init_normal`` (``normal02``) by default, or
    torch's own init (``torch``: kaiming-uniform convs, BatchNorm at scale 1,
    bias 0; relativistic_gan/relativistic_gan.py:58-73); the Linear keeps
    torch's init."""

    def __init__(self, img_size: int, channels: int, latent_dim: int, first_bn: bool = True,
                 *, init_mode: str = "normal02", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.init_size = img_size // 4
        self.l1 = nn.Sequential(Linear(latent_dim, 128 * self.init_size ** 2, generator=generator))
        conv = lambda i, o: Conv2d(i, o, 3, 1, 1, init_mode=init_mode, generator=generator)
        bn = lambda c, eps: BatchNorm2d(c, eps, init_mode=init_mode, generator=generator)
        head = [bn(128, 1e-5)] if first_bn else []
        self.conv_blocks = nn.Sequential(
            *head,
            Upsample(2), conv(128, 128), bn(128, 0.8), LeakyReLU(0.2),
            Upsample(2), conv(128, 64), bn(64, 0.8), LeakyReLU(0.2),
            conv(64, channels), nn.Tanh(),
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        out = self.l1(z).view(z.shape[0], 128, self.init_size, self.init_size)
        return self.conv_blocks(out)


class DCGANTrunk(nn.Sequential):
    """Template B discriminator trunk (``tpugan/nn/blocks.py:DCGANTrunk``,
    dcgan/dcgan.py:74-92): four [Conv3x3 s2 p1, LReLU(0.2), Dropout2d(0.25),
    BatchNorm2d(0.8) but in the first] blocks of 16, 32, 64 and 128 filters,
    numbered as the reference's ``nn.Sequential``, with the convs and
    BatchNorms in ``init_mode`` (as ``DCGANGenerator``'s); the output is
    flattened in torch's ``view(B, -1)`` order. In training ``forward`` takes
    one Dropout2d keep mask a block, in call order (``draw_masks``)."""

    def __init__(self, channels: int, *, init_mode: str = "normal02",
                 generator: Optional[torch.Generator] = None):
        layers = []
        fan_in = channels
        for i, f in enumerate((16, 32, 64, 128)):
            layers += [Conv2d(fan_in, f, 3, 2, 1, init_mode=init_mode, generator=generator),
                       LeakyReLU(0.2), Dropout2d(0.25)]
            if i > 0:
                layers.append(BatchNorm2d(f, 0.8, init_mode=init_mode, generator=generator))
            fan_in = f
        super().__init__(*layers)

    def draw_masks(self, batch: int, generator: torch.Generator) -> list:
        """One (batch, C, 1, 1) keep mask for each Dropout2d, in call order."""
        convs = [layer for layer in self if isinstance(layer, Conv2d)]
        drops = [layer for layer in self if isinstance(layer, Dropout2d)]
        return [d.draw_mask((batch, c.out_channels, 1, 1), generator)
                for c, d in zip(convs, drops)]

    def forward(self, img: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        x = forward_masked(self, img, masks)
        return x.reshape(x.shape[0], -1)


class DCGANDiscriminator(nn.Module):
    """Template B discriminator (``tpugan/nn/blocks.py:DCGANDiscriminator``,
    dcgan/dcgan.py:74-99): ``model`` = the trunk, ``adv_layer`` =
    Linear(128 * (s/16)^2 -> 1) [+ Sigmoid; lsgan and relativistic_gan have
    none]; ``init_mode`` is the trunk's."""

    def __init__(self, img_size: int, channels: int, sigmoid: bool = True,
                 *, init_mode: str = "normal02", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = DCGANTrunk(channels, init_mode=init_mode, generator=generator)
        head = [Linear(128 * (img_size // 2 ** 4) ** 2, 1, generator=generator)]
        if sigmoid:
            head.append(nn.Sigmoid())
        self.adv_layer = nn.Sequential(*head)

    def draw_masks(self, batch: int, generator: torch.Generator) -> list:
        return self.model.draw_masks(batch, generator)

    def forward(self, img: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        return self.adv_layer(self.model(img, masks))


class DCGANAuxDiscriminator(nn.Module):
    """The template-B discriminator with several output heads that acgan,
    sgan and infogan each declare (acgan/acgan.py:74-100, sgan/sgan.py:76-99,
    infogan/infogan.py:95-121): ``conv_blocks`` = the trunk, then one
    ``nn.Sequential`` a head, Linear(128 * (s/16)^2 -> n) and its tail
    (Sigmoid, Softmax or nothing), registered under the reference's names
    in order. ``forward`` returns the heads' outputs as a tuple."""

    def __init__(self, img_size: int, channels: int, heads: Sequence[Tuple[str, int, list]],
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_blocks = DCGANTrunk(channels, generator=generator)
        feat = 128 * (img_size // 2 ** 4) ** 2
        self.head_names = [name for name, _, _ in heads]
        for name, n, tail in heads:
            setattr(self, name, nn.Sequential(Linear(feat, n, generator=generator), *tail))

    def draw_masks(self, batch: int, generator: torch.Generator) -> list:
        return self.conv_blocks.draw_masks(batch, generator)

    def forward(self, img: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> tuple:
        feat = self.conv_blocks(img, masks)
        return tuple(getattr(self, name)(feat) for name in self.head_names)
