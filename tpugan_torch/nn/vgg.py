"""The VGG19 feature extractor, torchvision's ``vgg19().features`` layout
(``tpugan/nn/vgg.py``).

srgan's perceptual loss takes features[:18] (srgan/models.py:8-15), esrgan's
features[:35], conv5_4 before its ReLU (esrgan/models.py:8-15). The
reference loads ImageNet weights; nothing is fetched here. Weights load
from ``<data_dir>/vgg19_features.npz`` when it is there (``conv<i>_kernel``
HWIO and ``conv<i>_bias``, i the torch feature index), else the extractor
keeps its ``he`` init, N(0, sqrt(2 / fan_in)), a usable random-feature
perceptual metric (torch's default init makes the activations vanish by
conv5). Either way it is frozen and in eval mode.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tpugan_torch.nn.layers import Conv2d

# torchvision's vgg19 features: (torch index, out channels) of each conv,
# "M" for the 2x2 max pools; the ReLUs sit at the indices between.
VGG19_LAYOUT = [
    (0, 64), (2, 64), (4, "M"),
    (5, 128), (7, 128), (9, "M"),
    (10, 256), (12, 256), (14, 256), (16, 256), (18, "M"),
    (19, 512), (21, 512), (23, 512), (25, 512), (27, "M"),
    (28, 512), (30, 512), (32, 512), (34, 512), (36, "M"),
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class VGG19Features(nn.Sequential):
    """features[0:cut] as a ``Sequential`` over the torch indices, so the
    keys are ``<i>.weight``/``<i>.bias``; the ReLU after the last conv is
    left out when the cut lands on it (``Sequential[:cut]``)."""

    def __init__(self, cut: int, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        convs = {idx: spec for idx, spec in VGG19_LAYOUT}
        layers, cin = [], in_channels
        for idx in range(cut):
            spec = convs.get(idx)
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
            elif spec is not None:
                layers.append(Conv2d(cin, spec, 3, 1, 1, init_mode="he", generator=generator))
                cin = spec
            else:
                layers.append(nn.ReLU())
        super().__init__(*layers)
        self.requires_grad_(False)
        self.eval()  # feature_extractor.eval() (srgan.py:62)

    @torch.no_grad()
    def load_hwio(self, arrays: Dict[str, np.ndarray]) -> None:
        """``conv<i>_kernel`` (HWIO) and ``conv<i>_bias`` into ``<i>.weight``
        (OIHW) and ``<i>.bias``, by name; a conv without a kernel keeps its
        weights."""
        for idx, layer in enumerate(self):
            kernel = arrays.get(f"conv{idx}_kernel")
            if isinstance(layer, nn.Conv2d) and kernel is not None:
                layer.weight.copy_(torch.tensor(np.asarray(kernel, np.float32)).permute(3, 2, 0, 1))
                layer.bias.copy_(torch.tensor(np.asarray(arrays[f"conv{idx}_bias"], np.float32)))

    def load_flax_params(self, params: Dict) -> None:
        """The JAX package's ``VGG19Features`` parameters, ``conv<i>`` to
        ``<i>``, by name: a jitted tree comes back key-sorted (``conv10``
        before ``conv2``), and convs of one shape would pair crosswise by
        kind and shape in order. Every conv must have its leaves."""
        arrays = {}
        for name, scope in params.items():
            while "kernel" not in scope:  # the wrapper's inner nn.Conv
                (scope,) = scope.values()
            arrays[f"{name}_kernel"], arrays[f"{name}_bias"] = scope["kernel"], scope["bias"]
        want = {f"conv{i}_kernel" for i, m in enumerate(self) if isinstance(m, nn.Conv2d)}
        if set(k for k in arrays if k.endswith("_kernel")) != want:
            raise ValueError(f"VGG19 features [:{len(self)}] take {sorted(want)}, "
                             f"got {sorted(arrays)}")
        self.load_hwio(arrays)


def load_vgg19_npz(module: VGG19Features, path: str) -> VGG19Features:
    """Overlay converted torchvision weights (``tpugan/nn/vgg.py:
    load_vgg19_npz``): ``conv<i>_kernel`` HWIO float32, ``conv<i>_bias``."""
    with np.load(path) as data:
        module.load_hwio({k: data[k] for k in data.files})
    return module


def vgg_features(cut: int, data_dir: str, device, generator=None) -> VGG19Features:
    """``VGG19Features(cut)`` on ``device``, with the weights of
    ``<data_dir>/vgg19_features.npz`` if it is there, He-random otherwise;
    says which, as the JAX package does."""
    module = VGG19Features(cut, generator=generator)
    npz = os.path.join(data_dir, "vgg19_features.npz")
    if os.path.exists(npz):
        load_vgg19_npz(module, npz)
        print("[tpugan] loaded VGG19 weights from %s" % npz)
    else:
        print("[tpugan] vgg19_features.npz not found under --data_dir — using "
              "randomly initialized VGG19 for the perceptual loss")
    return module.to(device)


_ON_DEVICE: Dict = {}


def _channel(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a (1, C, 1, 1) tensor on ``like``'s device, copied there
    once: a copy from pageable host memory each step would wait for the
    device."""
    key = (id(a), like.device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(a).to(like.device).view(1, -1, 1, 1)
    return _ON_DEVICE[key]


def imagenet_normalize(x01: torch.Tensor) -> torch.Tensor:
    """NCHW in [0, 1] to ImageNet-normalized (srgan/datasets.py:11-13)."""
    return (x01 - _channel(IMAGENET_MEAN, x01)) / _channel(IMAGENET_STD, x01)


def imagenet_denormalize(x: torch.Tensor) -> torch.Tensor:
    """esrgan/datasets.py:16-20, with its clamp to [0, 255] kept: with
    ``save_image``'s [0, 1] clip it gives the reference's output."""
    return torch.clamp(x * _channel(IMAGENET_STD, x) + _channel(IMAGENET_MEAN, x), 0.0, 255.0)
