"""Fréchet distance (FID) for the port (``tpugan/metrics/fid.py``).

- ``activation_statistics``, ``_sqrtm_product``, ``frechet_distance`` and
  ``fid_from_features``: the port's own copy of the JAX package's numpy
  float64 code, the same operations in the same order, so the same features
  give the same distance.
- ``InceptionFeatureModel``: the canonical backbone, InceptionV3's pooled
  2048 features (``metrics.inception``), weights from
  ``<data_dir>/inception_v3.npz`` when it is there.
- ``VGGFeatureModel``: VGG19 ``features[:18]`` (``nn.vgg``) mean-pooled over
  space, weights from ``<data_dir>/vgg19_features.npz`` when it is there.
- ``feature_model`` picks InceptionV3 when its npz is on disk, else VGG19;
  ``compute_fid`` scores two streams of image batches.

Image batches are NCHW tensors in [-1, 1], the generators' output; a
one-channel batch is repeated to three. The extractors run in float32 on
the card unless the caller passes another device (the tests pass the CPU),
with TF32 off on CUDA, the port's float32 contract.

Without a weight file an extractor is He-random from a ``torch.Generator``
seeded 0. That is not the JAX package's ``PRNGKey(0)`` draw: such FIDs
compare only within one framework. Load the same npz on both sides to
compare the frameworks.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np
import torch

from tpugan_torch.metrics.inception import InceptionV3Features, load_inception_npz
from tpugan_torch.nn.vgg import VGG19Features, imagenet_normalize, load_vgg19_npz
from tpugan_torch.train.loop import card_device


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) float features -> (mu (D,), sigma (D, D)) with the standard
    unbiased covariance."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr(sqrtm(sigma1 @ sigma2)) for symmetric PSD sigma1, sigma2: the
    eigenvalues of sqrtm(B^1/2 A B^1/2), which is symmetric PSD."""
    w2, v2 = np.linalg.eigh(sigma2)
    w2 = np.clip(w2, 0.0, None)
    b_half = (v2 * np.sqrt(w2)) @ v2.T
    m = b_half @ sigma1 @ b_half
    w = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sqrt(np.clip(w, 0.0, None)).sum())


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """||mu1 - mu2||^2 + tr(s1 + s2 - 2 sqrtm(s1 s2))."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    tr_sqrt = _sqrtm_product(np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu1, s1 = activation_statistics(real)
    mu2, s2 = activation_statistics(fake)
    return frechet_distance(mu1, s1, mu2, s2)


class _FeatureModel:
    """The shared call: each batch from [-1, 1] to [0, 1], three channels,
    ImageNet-normalized, through ``_features``; the rows gathered on the
    host as one (N, D) float32 array."""

    def __init__(self, module: torch.nn.Module, device):
        self.device = card_device(device)
        self.module = module.to(self.device)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x)

    @torch.no_grad()
    def extract(self, x: torch.Tensor) -> torch.Tensor:
        """The (B, D) features of one NCHW batch, on the model's device."""
        x = (x.to(self.device, torch.float32) + 1.0) / 2.0
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        return self._features(imagenet_normalize(x))

    def __call__(self, batches: Iterable[torch.Tensor]) -> np.ndarray:
        return np.concatenate([self.extract(b).cpu().numpy() for b in batches], axis=0)


class InceptionFeatureModel(_FeatureModel):
    """InceptionV3 pool3 features (B, 2048): ``<data_dir>/inception_v3.npz``
    when it is there (``pretrained``), else He-random from a generator
    seeded 0."""

    def __init__(self, data_dir: str = "data", device=None):
        module = InceptionV3Features(generator=torch.Generator().manual_seed(0))
        npz = os.path.join(data_dir, "inception_v3.npz")
        self.pretrained = os.path.exists(npz)
        if self.pretrained:
            load_inception_npz(module, npz)
        super().__init__(module, device)


# VGG19 ``features[:18]``: up to relu3_4, the JAX package's FID cut.
VGG_CUT = 18


class VGGFeatureModel(_FeatureModel):
    """VGG19 ``features[:18]`` mean-pooled over space, (B, 256):
    ``<data_dir>/vgg19_features.npz`` when it is there (``pretrained``),
    else He-random from a generator seeded 0."""

    def __init__(self, data_dir: str = "data", device=None):
        module = VGG19Features(VGG_CUT, generator=torch.Generator().manual_seed(0))
        npz = os.path.join(data_dir, "vgg19_features.npz")
        self.pretrained = os.path.exists(npz)
        if self.pretrained:
            load_vgg19_npz(module, npz)
        super().__init__(module, device)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x).mean(dim=(2, 3))


def feature_model(data_dir: str = "data", device=None):
    """InceptionV3 when ``<data_dir>/inception_v3.npz`` is there
    (literature-comparable), else VGG19."""
    if os.path.exists(os.path.join(data_dir, "inception_v3.npz")):
        return InceptionFeatureModel(data_dir, device)
    return VGGFeatureModel(data_dir, device)


def compute_fid(real_batches: Iterable[torch.Tensor], fake_batches: Iterable[torch.Tensor],
                data_dir: str = "data", device=None) -> float:
    """The FID of two streams of NCHW batches in [-1, 1], through
    ``feature_model(data_dir)`` on ``device`` (CUDA when None)."""
    model = feature_model(data_dir, device)
    return fid_from_features(model(real_batches), model(fake_batches))
