"""The InceptionV3 feature trunk for literature-comparable FID
(``tpugan/metrics/inception.py``): torchvision's ``inception_v3`` without
AuxLogits and fc, its layers registered under torchvision's attribute names
and in its order (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.
running_mean``, ...), so a converted ``inception_v3.npz``
(``scripts/convert_inception.py``: the trunk's ``state_dict`` entries, AuxLogits
and fc dropped) loads with ``strict=True``, and ``io.interop.load_jax_params``
carries the JAX package's parameters across by kind and shape in that order.

- ``BasicConv2d``: conv without bias, BatchNorm with eps 1e-3 on its running
  statistics (always eval, as the JAX trunk applies it), ReLU.
- The 3x3 average pools count the padding (``F.avg_pool2d``'s default, the
  JAX package's ``avg_pool``); the 3x3 stride-2 max pools are unpadded.
- The input is resized to 299x299 bilinearly (``ops.image.resize_bilinear``:
  ``jax.image.resize``'s half-pixel centres, antialiased when it shrinks),
  then torchvision's ``transform_input`` affine, always applied, maps ImageNet-normalized
  input to the TF convention the pretrained weights expect.

Without a weight file the convs are He-random, N(0, sqrt(2 / fan_out)), from
a ``torch.Generator`` the caller seeds (``InceptionFeatureModel``: seed 0).
That is not the JAX package's ``PRNGKey(0)`` draw, so FIDs from a He-random
trunk compare only within one framework; load the same npz on both sides to
compare across them.

Architecture: torchvision.models.inception (BSD), layer names and shapes
only.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops.image import resize_bilinear

# torchvision's transform_input: x * scale + shift per channel.
_TRANSFORM_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_TRANSFORM_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm(eps 1e-3, running statistics) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)
        kh, kw = self.conv.kernel_size
        with torch.no_grad():
            self.conv.weight.normal_(0.0, math.sqrt(2.0 / (cout * kh * kw)), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return F.relu(x)


def _pool_avg(x):
    return F.avg_pool2d(x, 3, 1, 1)


def _pool_max(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, generator=None):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, generator=generator, **k)
        self.branch1x1 = c(cin, 64, 1)
        self.branch5x5_1 = c(cin, 48, 1)
        self.branch5x5_2 = c(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = c(cin, 64, 1)
        self.branch3x3dbl_2 = c(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = c(96, 96, 3, padding=1)
        self.branch_pool = c(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_pool_avg(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, generator=None):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, generator=generator, **k)
        self.branch3x3 = c(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = c(cin, 64, 1)
        self.branch3x3dbl_2 = c(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = c(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _pool_max(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, generator=None):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, generator=generator, **k)
        c7 = channels_7x7
        self.branch1x1 = c(cin, 192, 1)
        self.branch7x7_1 = c(cin, c7, 1)
        self.branch7x7_2 = c(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = c(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = c(cin, c7, 1)
        self.branch7x7dbl_2 = c(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = c(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = c(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = c(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = c(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for m in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_pool_avg(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, generator=None):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, generator=generator, **k)
        self.branch3x3_1 = c(cin, 192, 1)
        self.branch3x3_2 = c(192, 320, 3, stride=2)
        self.branch7x7x3_1 = c(cin, 192, 1)
        self.branch7x7x3_2 = c(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = c(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = c(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for m in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _pool_max(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, generator=None):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, generator=generator, **k)
        self.branch1x1 = c(cin, 320, 1)
        self.branch3x3_1 = c(cin, 384, 1)
        self.branch3x3_2a = c(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = c(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = c(cin, 448, 1)
        self.branch3x3dbl_2 = c(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = c(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = c(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = c(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_pool_avg(x))], 1)


class InceptionV3Features(nn.Module):
    """(B, 3, H, W) ImageNet-normalized images to their (B, 2048) pooled
    pool3 features: resized to 299x299 unless they are, torchvision's ``transform_input``
    affine, the trunk, and the mean over the 8x8 map. Frozen."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = lambda *a, **k: BasicConv2d(*a, generator=generator, **k)
        self.Conv2d_1a_3x3 = c(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = c(32, 32, 3)
        self.Conv2d_2b_3x3 = c(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = c(64, 80, 1)
        self.Conv2d_4a_3x3 = c(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, generator)
        self.Mixed_5c = InceptionA(256, 64, generator)
        self.Mixed_5d = InceptionA(288, 64, generator)
        self.Mixed_6a = InceptionB(288, generator)
        self.Mixed_6b = InceptionC(768, 128, generator)
        self.Mixed_6c = InceptionC(768, 160, generator)
        self.Mixed_6d = InceptionC(768, 160, generator)
        self.Mixed_6e = InceptionC(768, 192, generator)
        self.Mixed_7a = InceptionD(768, generator)
        self.Mixed_7b = InceptionE(1280, generator)
        self.Mixed_7c = InceptionE(2048, generator)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2:] != (299, 299):
            x = resize_bilinear(x, (299, 299))
        scale = x.new_tensor(_TRANSFORM_SCALE).view(1, 3, 1, 1)
        shift = x.new_tensor(_TRANSFORM_SHIFT).view(1, 3, 1, 1)
        x = x * scale + shift
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _pool_max(x)
        x = _pool_max(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                  self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                  self.Mixed_7c):
            x = m(x)
        return x.mean(dim=(2, 3))


def load_inception_npz(module: InceptionV3Features, path: str) -> InceptionV3Features:
    """A converted torchvision checkpoint (``scripts/convert_inception.py``'s
    npz: the trunk's ``state_dict`` by key) into ``module``, strictly."""
    with np.load(path) as data:
        sd = {k: torch.from_numpy(np.asarray(data[k])) for k in data.files}
    module.load_state_dict(sd, strict=True)
    return module
