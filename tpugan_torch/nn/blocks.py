"""Template-A networks of ``tpugan/nn/blocks.py``: the MLP generator and the
MLP discriminator / critic, on NCHW images.

Both keep the reference's ``nn.Sequential`` numbering (gan/gan.py:38-81), so
their ``state_dict`` keys are the reference's. ``img.view(B, -1)`` and
``flat.view(B, C, H, W)`` are torch's own orders; ``flatten_nchw`` and
``unflatten_nchw`` reproduce them on the JAX side, so the first Linear's
weight lines up with a plain transpose of the flax kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from tpugan_torch.nn.layers import BatchNorm1d, LeakyReLU, Linear


class MLPGenerator(nn.Module):
    """Template A generator (``tpugan/nn/blocks.py:32-57``): Linear ->
    [BatchNorm1d(eps=0.8)] -> LeakyReLU(0.2) through ``widths`` (no norm on
    the first block), a Linear to C*H*W, Tanh, then ``view(B, C, H, W)``."""

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
        layers = []
        fan_in = latent_dim
        for i, w in enumerate(widths):
            layers.append(Linear(fan_in, w, generator=generator))
            if i > 0:
                layers.append(BatchNorm1d(w, bn_eps))
            layers.append(LeakyReLU(0.2))
            fan_in = w
        layers += [Linear(fan_in, math.prod(self.img_shape), generator=generator), nn.Tanh()]
        self.model = nn.Sequential(*layers)

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
