"""MNIST-class dataset sources: the port's copy of ``tpugan/data/sources.py``
(:28-101, :190-211), in numpy, byte-identical.

MNIST IDX files are read from disk when present under ``--data_dir``;
otherwise, or with ``--synthetic_data``, a deterministic procedural dataset
of class-conditioned Gaussian-bump glyphs stands in.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset of uint8 images (N, H, W, C) + int labels (N,)."""

    images: np.ndarray
    labels: np.ndarray

    def __post_init__(self):
        assert self.images.dtype == np.uint8 and self.images.ndim == 4
        assert len(self.images) == len(self.labels)

    def __len__(self) -> int:
        return len(self.images)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist(data_dir: str, train: bool = True) -> Optional[ArrayDataset]:
    """Load MNIST IDX files if present under several conventional layouts."""
    prefix = "train" if train else "t10k"
    candidates = [
        os.path.join(data_dir, "mnist"),
        os.path.join(data_dir, "mnist", "MNIST", "raw"),
        data_dir,
    ]
    for root in candidates:
        for ext in ("", ".gz"):
            img_p = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
            lbl_p = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(img_p) and os.path.exists(lbl_p):
                imgs = _read_idx(img_p)[..., None]  # (N, 28, 28, 1)
                labels = _read_idx(lbl_p).astype(np.int32)
                return ArrayDataset(imgs, labels)
    return None


def synthetic_image_dataset(
    n: int = 4096,
    img_size: int = 28,
    channels: int = 1,
    n_classes: int = 10,
    seed: int = 0,
) -> ArrayDataset:
    """Deterministic procedural dataset: class-conditioned Gaussian-bump
    glyphs with per-sample jitter. Non-degenerate (distinct per-class modes,
    continuous intra-class variation) so adversarial losses behave, and
    cheap enough to regenerate in tests."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / (img_size - 1)
    images = np.zeros((n, img_size, img_size, channels), np.float32)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    # Fixed per-class anchor blob layout.
    class_rng = np.random.default_rng(1234)
    anchors = class_rng.uniform(0.15, 0.85, size=(n_classes, 3, 2)).astype(np.float32)
    widths = class_rng.uniform(0.08, 0.2, size=(n_classes, 3)).astype(np.float32)
    for i in range(n):
        c = labels[i]
        jitter = rng.normal(0, 0.04, size=(3, 2)).astype(np.float32)
        img = np.zeros((img_size, img_size), np.float32)
        for b in range(3):
            cy, cx = anchors[c, b] + jitter[b]
            w = widths[c, b]
            img += np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * w * w)))
        img = img / max(img.max(), 1e-6)
        for ch in range(channels):
            scale = 1.0 if channels == 1 else float(0.5 + 0.5 * ((c + ch) % 3) / 2)
            images[i, :, :, ch] = img * scale
    return ArrayDataset((images * 255).astype(np.uint8), labels)


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis (jax/_src/image/scale.py:
    ``compute_weight_mat``, antialias on): the triangle kernel at half-pixel
    centres, widened by in/out when shrinking, each column normalised to sum
    1, and zero where the sample falls outside the input."""
    inv_scale = np.float32(1.0 / (out_size / in_size))  # in float64 first, as in JAX
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_dataset(ds: ArrayDataset, img_size: int) -> ArrayDataset:
    """One whole-dataset bilinear resize to ``img_size`` square
    (``tpugan/data/sources.py:resize_dataset``, in place of the reference's
    per-sample transforms.Resize): what ``jax.image.resize(..., "bilinear")``
    gives, half-pixel centres when enlarging and the antialiased triangle
    kernel when shrinking, in float32, then clipped to [0, 255] and truncated
    to uint8. At the dataset's own size it returns ``ds``."""
    n, h, w, c = ds.images.shape
    if h == img_size and w == img_size:
        return ds
    x = ds.images.astype(np.float32)
    x = np.einsum("nhwc,hH->nHwc", x, _bilinear_weights(h, img_size), optimize=True)
    x = np.einsum("nHwc,wW->nHWc", x, _bilinear_weights(w, img_size), optimize=True)
    return ArrayDataset(np.clip(x, 0, 255).astype(np.uint8), ds.labels)


def mnist_or_synthetic(
    data_dir: str,
    img_size: int = 28,
    channels: int = 1,
    synthetic: bool = False,
    synthetic_n: int = 4096,
    seed: int = 0,
) -> Tuple[ArrayDataset, bool]:
    """MNIST from disk when available (and not forced synthetic); else the
    procedural fallback. Returns (dataset, is_real)."""
    if not synthetic:
        ds = load_mnist(data_dir)
        if ds is not None:
            ds = resize_dataset(ds, img_size)
            if channels != 1:
                imgs = np.repeat(ds.images, channels, axis=-1)
                ds = ArrayDataset(imgs, ds.labels)
            return ds, True
    return (
        synthetic_image_dataset(synthetic_n, img_size, channels, seed=seed),
        False,
    )
