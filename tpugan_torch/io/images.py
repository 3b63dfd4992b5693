"""Sample-grid PNG writer with torchvision.utils.save_image's layout
(``tpugan/io/images.py``): padding 2, pad value 0, min/max normalisation
over the whole batch unless ``value_range`` is given. Input is NHWC float
numpy. PNGs are encoded with ``zlib`` and ``struct`` alone: no Pillow.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def _normalize(t: np.ndarray, value_range: Optional[Tuple[float, float]]) -> np.ndarray:
    if value_range is not None:
        low, high = value_range
    else:
        low, high = float(t.min()), float(t.max())
    t = np.clip(t, low, high)
    return (t - low) / (high - low + 1e-5)


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    padding: int = 2,
    normalize: bool = False,
    value_range: Optional[Tuple[float, float]] = None,
    pad_value: float = 0.0,
) -> np.ndarray:
    """(N, H, W, C) -> (grid_H, grid_W, C) float in [0, 1]."""
    images = np.asarray(images, dtype=np.float32)
    if normalize:
        images = _normalize(images, value_range)
    n, h, w, c = images.shape
    xmaps = min(nrow, n)
    ymaps = int(math.ceil(n / xmaps))
    gh = ymaps * (h + padding) + padding
    gw = xmaps * (w + padding) + padding
    grid = np.full((gh, gw, c), pad_value, dtype=np.float32)
    k = 0
    for y in range(ymaps):
        for x in range(xmaps):
            if k >= n:
                break
            gy = y * (h + padding) + padding
            gx = x * (w + padding) + padding
            grid[gy : gy + h, gx : gx + w] = images[k]
            k += 1
    return grid


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(u8: np.ndarray) -> bytes:
    """8-bit PNG of an (H, W, 1) grey or (H, W, 3) RGB uint8 array."""
    h, w, c = u8.shape
    color_type = {1: 0, 3: 2}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(u8).reshape(h, w * c)], axis=1
    )  # filter byte 0 (none) before each row
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def save_image(
    images: np.ndarray,
    path: str,
    nrow: int = 8,
    normalize: bool = False,
    value_range: Optional[Tuple[float, float]] = None,
    padding: int = 2,
) -> None:
    """torchvision.utils.save_image: grid -> 8-bit PNG."""
    arr = np.asarray(images, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    grid = make_grid(arr, nrow=nrow, padding=padding, normalize=normalize,
                     value_range=value_range)
    if not normalize:
        grid = np.clip(grid, 0.0, 1.0)
    u8 = (grid * 255.0 + 0.5).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(u8))
