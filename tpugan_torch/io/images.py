"""Sample-grid PNG writer with torchvision.utils.save_image's layout
(``tpugan/io/images.py``): padding 2, pad value 0, min/max normalisation
over the whole batch unless ``value_range`` is given. Input is NHWC float
numpy. PNGs are encoded and decoded with ``zlib`` and ``struct`` alone: no
Pillow, which the card machine does not have; ``read_rgb`` takes Pillow
only for other formats.
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


# Channels of each PNG colour type decoded here: grey, RGB, grey+alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth) of
    ``h`` rows of ``stride`` bytes, ``bpp`` bytes a pixel."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype in (0, 2):
            cur = (line + (prev if ftype == 2 else 0)) & 0xFF
        elif ftype == 1:  # a running sum along each channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif ftype in (3, 4):
            cur = line.copy()
            for x in range(stride):  # each byte depends on its left neighbour's result
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {ftype} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 of a non-interlaced 8-bit grey (C 1), RGB (3),
    grey+alpha (2) or RGBA (4) PNG, filters 0-4; other PNGs raise."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or interlace or color_type not in _PNG_CHANNELS:
        raise ValueError(f"PNG with bit depth {depth}, colour type {color_type}, interlace "
                         f"{interlace}: only non-interlaced 8-bit grey, RGB and RGBA are read")
    c = _PNG_CHANNELS[color_type]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an image file, as PIL's ``convert("RGB")`` gives
    it: grey repeated, alpha dropped. PNGs through ``decode_png``; other
    formats through Pillow, imported here."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            img = decode_png(f.read())
        return np.repeat(img[..., :1], 3, axis=2) if img.shape[2] < 3 else img[..., :3]
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)
