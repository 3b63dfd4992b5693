"""The image-to-image networks of ``tpugan/nn/im2im.py`` on NCHW: the
CycleGAN ResNet generator, the U-Net blocks and pix2pix's U-Net generator,
and the PatchGAN discriminator family.

Layers are registered in call order, which is the flax insertion order of
the JAX modules, so ``tpugan_torch.io.interop.load_jax_params`` pairs them
in order. Each ``nn.Sequential`` entry is named by its index in the
reference's own ``nn.Sequential`` (cyclegan/models.py:22-122,
pix2pix/models.py:20-133), so a ``state_dict`` carries the reference's keys.
A fused IN+activation entry stands for two reference entries and the next
index skips one.

Dropout in the U-Nets takes keep masks: a network's ``forward`` takes
``masks``, one for each of its dropout sites in call order (the tests pass
the JAX package's), or draws each one from ``generator`` where it is
applied.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Optional, Sequence

import torch
from torch import nn

from tpugan_torch.nn.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dropout,
    InstanceNorm,
    LeakyReLU,
    MaskedDropout,
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
    1. The ``nn.Sequential`` is registered as ``block_name``: ``block`` in
    cyclegan (cyclegan/models.py:22-37), ``conv_block`` in unit
    (unit/models.py:36-50)."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None,
                 init_mode: str = "normal02zero", block_name: str = "block"):
        super().__init__()
        conv = lambda: Conv2d(features, features, 3, init_mode=init_mode, generator=generator)
        self.block_name = block_name
        self.add_module(block_name, _numbered([
            (ReflectionPad(1), 1), (conv(), 1), (InstanceNorm(act_slope=0.0), 2),
            (ReflectionPad(1), 1), (conv(), 1), (InstanceNorm(), 1),
        ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + getattr(self, self.block_name)(x)


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


def _norm_layers(norm: str, features: int, slope: float, generator) -> list:
    """The norm and the activation after it, as (module, reference entries):
    ``instance`` is IN fused with leaky(slope); ``affine`` torch's affine IN,
    then the activation on its own (the JAX package applies the affine
    outside its kernel); ``batch08`` BatchNorm2d(eps=0.8) with scale ~
    N(1, 0.02), then the activation."""
    act = LeakyReLU(slope) if slope else nn.ReLU()
    if norm == "instance":
        return [(InstanceNorm(act_slope=slope), 2)]
    if norm == "affine":
        return [(InstanceNorm(features, affine=True), 1), (act, 1)]
    if norm == "batch08":
        return [(BatchNorm2d(features, 0.8, init_mode="normal02", generator=generator), 1),
                (act, 1)]
    raise ValueError(f"norm {norm!r}: instance, affine or batch08")


def _apply(model: nn.Sequential, x: torch.Tensor, masks: Optional[Iterator],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``model`` in order; a dropout layer in training takes the next of
    ``masks``, or draws its mask from ``generator``."""
    for layer in model:
        if isinstance(layer, MaskedDropout) and layer.training:
            if masks is not None:
                x = layer(x, next(masks))
            elif generator is not None:
                x = layer(x, layer.draw_mask(x.shape, generator))
            else:
                x = layer(x)  # raises: training needs a mask
        else:
            x = layer(x)
    return x


class UNetDown(nn.Module):
    """Conv(4, 2, 1) -> [norm] -> LeakyReLU(0.2) -> [Dropout]
    (``tpugan/nn/im2im.py:48-72``). ``use_bias`` gives discogan's biased
    convs, ``norm`` the norm as ``_norm_layers`` (pix2pix and discogan:
    ``instance``, IN+LeakyReLU(0.2) in one kernel, the same function and
    gradient as the JAX package's two steps; dualgan: ``affine``; ccgan:
    ``batch08``), ``normalize=False`` none."""

    def __init__(self, in_size: int, out_size: int, normalize: bool = True,
                 dropout: float = 0.0, use_bias: bool = False, norm: str = "instance",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [(Conv2d(in_size, out_size, 4, 2, 1, bias=use_bias, init_mode="normal02",
                          generator=generator), 1)]
        if normalize:
            layers += _norm_layers(norm, out_size, 0.2, generator)
        else:
            layers.append((LeakyReLU(0.2), 1))
        if dropout:
            layers.append((Dropout(dropout), 1))
        self.model = _numbered(layers)

    def forward(self, x, masks: Optional[Iterator] = None, generator=None):
        return _apply(self.model, x, masks, generator)


class UNetUp(nn.Module):
    """ConvTranspose(4, 2, 1) -> norm -> ReLU -> [Dropout], then the skip
    concatenated on the channel axis (``tpugan/nn/im2im.py:75-96``). With
    ``norm="instance"`` IN+ReLU runs as one kernel at slope 0, whose
    gradient at exactly 0 is 1 where the JAX package's ``nn.relu`` gives 0;
    ``affine`` and ``batch08`` apply torch's ReLU, as the JAX package's."""

    def __init__(self, in_size: int, out_size: int, dropout: float = 0.0,
                 use_bias: bool = False, norm: str = "instance",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [(ConvTranspose2d(in_size, out_size, 4, 2, 1, bias=use_bias,
                                   generator=generator), 1)]
        layers += _norm_layers(norm, out_size, 0.0, generator)
        if dropout:
            layers.append((Dropout(dropout), 1))
        self.model = _numbered(layers)

    def forward(self, x, skip, masks: Optional[Iterator] = None, generator=None):
        return torch.cat([_apply(self.model, x, masks, generator), skip], dim=1)


class UNet(nn.Module):
    """A U-Net: ``downs`` registered as down1..downN, ``ups`` as up1..upM, each
    up taking the output of the down it mirrors as its skip, then ``final``
    (an ``nn.Sequential``), registered in the reference's order. The input at
    low resolution (ccgan's, ``tpugan/models/ccgan.py:101``) is concatenated
    after down ``lowres_at`` when given. ``forward`` takes the dropout masks
    of every site in call order, or draws them from ``generator``."""

    def __init__(self, downs: Sequence[UNetDown], ups: Sequence[UNetUp], final: nn.Sequential,
                 lowres_at: Optional[int] = None):
        super().__init__()
        for i, down in enumerate(downs):
            self.add_module(f"down{i + 1}", down)
        for i, up in enumerate(ups):
            self.add_module(f"up{i + 1}", up)
        self.final = final
        self.n_down, self.n_up, self.lowres_at = len(downs), len(ups), lowres_at

    def run(self, x, masks=None, generator=None, lowres=None):
        masks = iter(masks) if masks is not None else None
        skips = []
        for i in range(self.n_down):
            x = getattr(self, f"down{i + 1}")(x, masks, generator)
            if i + 1 == self.lowres_at:
                x = torch.cat([x, lowres], dim=1)
            skips.append(x)
        for i in range(self.n_up):
            x = getattr(self, f"up{i + 1}")(x, skips[-2 - i], masks, generator)
        return self.final(x)

    def forward(self, x, masks=None, generator=None):
        return self.run(x, masks, generator)


class GeneratorUNet(UNet):
    """pix2pix's 8-down/7-up U-Net (``tpugan/nn/im2im.py:99-126``,
    pix2pix/models.py:55-101): bias-free convs, IN, dropout 0.5 at d4-d8 and
    u1-u4 (nine sites), then Upsample, ZeroPad2d((1, 0, 1, 0)), a 4x4 conv
    and tanh."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        g = generator
        downs = [UNetDown(in_channels, 64, normalize=False, generator=g),
                 UNetDown(64, 128, generator=g), UNetDown(128, 256, generator=g),
                 UNetDown(256, 512, dropout=0.5, generator=g)]
        downs += [UNetDown(512, 512, dropout=0.5, generator=g) for _ in range(3)]
        downs.append(UNetDown(512, 512, normalize=False, dropout=0.5, generator=g))
        ups = [UNetUp(512, 512, dropout=0.5, generator=g)]
        ups += [UNetUp(1024, 512, dropout=0.5, generator=g) for _ in range(3)]
        ups += [UNetUp(1024, 256, generator=g), UNetUp(512, 128, generator=g),
                UNetUp(256, 64, generator=g)]
        final = _numbered([(Upsample(2), 1), (ZeroPadLT(), 1),
                           (Conv2d(128, out_channels, 4, 1, 1, init_mode="normal02",
                                   generator=g), 1), (nn.Tanh(), 1)])
        super().__init__(downs, ups, final)


class PatchGAN(nn.Module):
    """Stride-2 conv blocks of ``filters`` (a norm and LeakyReLU(0.2) after
    all but the first), ZeroPad2d((1, 0, 1, 0)) and a 4x4 head of padding
    ``head_padding`` (``tpugan/nn/im2im.py:279-323``). cyclegan: four blocks,
    ``head_bias``, the defaults; pix2pix: ``in_channels=6`` (the caller
    concatenates the pair), no head bias, ``normal02``; discogan: three
    blocks; dualgan: three blocks, ``norm="batch08"`` (BatchNorm2d(eps=0.8),
    ``tpugan/nn/im2im.py:312-316``) and ``head_padding=0``. IN runs fused
    with the LeakyReLU(0.2)."""

    def __init__(
        self,
        in_channels: int = 3,
        head_bias: bool = True,
        generator: Optional[torch.Generator] = None,
        filters: Sequence[int] = (64, 128, 256, 512),
        norm: str = "instance",
        head_padding: int = 1,
        init_mode: str = "normal02zero",
    ):
        super().__init__()
        layers, cin = [], in_channels
        for i, f in enumerate(filters):
            layers.append((Conv2d(cin, f, 4, 2, 1, init_mode=init_mode, generator=generator), 1))
            if i == 0:
                layers.append((LeakyReLU(0.2), 1))
            else:
                layers += _norm_layers(norm, f, 0.2, generator)
            cin = f
        layers += [
            (ZeroPadLT(), 1),
            (Conv2d(cin, 1, 4, 1, head_padding, bias=head_bias, init_mode=init_mode,
                    generator=generator), 1),
        ]
        self.model = _numbered(layers)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)
