"""Image-to-image dataset helpers, copied from ``tpugan/data/im2im.py``
(that package imports JAX on import). Datasets decode once into uint8 NHWC
arrays; the per-epoch randomness (crop, flip, random B) runs on the loader's
host thread. Pillow is imported only to decode a real image folder.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

GLOB_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _list_images(folder: str) -> List[str]:
    if not os.path.isdir(folder):
        return []
    return sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith(GLOB_EXTS)
    )


def _load_folder(folder: str, height: int, width: int) -> Optional[np.ndarray]:
    """Decode a folder of images to a uint8 (N, H, W, 3) array (RGB)."""
    files = _list_images(folder)
    if not files:
        return None
    from PIL import Image

    out = np.zeros((len(files), height, width, 3), np.uint8)
    for i, f in enumerate(files):
        img = Image.open(f).convert("RGB").resize(
            (width, height), Image.BICUBIC
        )
        out[i] = np.asarray(img, np.uint8)
    return out


def load_paired_folder(
    root: str, split: str, height: int, width: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """pix2pix layout: ``root/<split>/*.jpg`` where each image is the A|B
    pair side by side (split-crop at W/2, pix2pix/datasets.py:21-24)."""
    files = _list_images(os.path.join(root, split))
    if not files:
        return None
    from PIL import Image

    a = np.zeros((len(files), height, width, 3), np.uint8)
    b = np.zeros((len(files), height, width, 3), np.uint8)
    for i, f in enumerate(files):
        img = Image.open(f).convert("RGB")
        w, h = img.size
        left = img.crop((0, 0, w // 2, h)).resize((width, height), Image.BICUBIC)
        right = img.crop((w // 2, 0, w, h)).resize((width, height), Image.BICUBIC)
        a[i] = np.asarray(left, np.uint8)
        b[i] = np.asarray(right, np.uint8)
    return a, b


def load_unpaired_folders(
    root: str, split: str, height: int, width: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """cyclegan layout: ``root/<split>/A`` and ``root/<split>/B``
    (cyclegan/datasets.py:17-22; download script restructures to this,
    data/download_cyclegan_dataset.sh:13-22)."""
    a = _load_folder(os.path.join(root, split, "A"), height, width)
    b = _load_folder(os.path.join(root, split, "B"), height, width)
    if a is None or b is None:
        return None
    return a, b


def synthetic_scene_pairs(
    n: int = 512,
    height: int = 128,
    width: int = 128,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural paired domains over shared geometry.

    Domain A: flat-shaded rectangles on a quantized palette ("labels").
    Domain B: the same rectangles with per-rect hue shift, smooth lighting
    gradient and speckle texture ("photo"). Deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    a = np.zeros((n, height, width, 3), np.float32)
    b = np.zeros((n, height, width, 3), np.float32)
    palette = np.array(
        [[220, 40, 40], [40, 180, 60], [50, 80, 220], [230, 200, 40],
         [160, 60, 200], [90, 200, 210]], np.float32,
    )
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(n):
        bg = palette[rng.integers(len(palette))] * 0.3
        a[i] = bg
        light = (
            0.7
            + 0.3 * (xx / width) * rng.uniform(-1, 1)
            + 0.3 * (yy / height) * rng.uniform(-1, 1)
        )[..., None]
        b[i] = bg * light
        for _ in range(rng.integers(4, 9)):
            c = palette[rng.integers(len(palette))]
            y0 = rng.integers(0, max(height - 8, 1))
            x0 = rng.integers(0, max(width - 8, 1))
            hh = rng.integers(8, max(height // 2, 9))
            ww = rng.integers(8, max(width // 2, 9))
            y1, x1 = min(y0 + hh, height), min(x0 + ww, width)
            a[i, y0:y1, x0:x1] = c
            hue_shift = rng.uniform(0.8, 1.2, size=3).astype(np.float32)
            b[i, y0:y1, x0:x1] = np.clip(c * hue_shift, 0, 255) * light[y0:y1, x0:x1]
        b[i] += rng.normal(0, 8, size=(height, width, 3))
    return (
        np.clip(a, 0, 255).astype(np.uint8),
        np.clip(b, 0, 255).astype(np.uint8),
    )


def unpaired_or_synthetic(
    data_dir: str,
    dataset_name: str,
    height: int,
    width: int,
    split: str = "train",
    synthetic: bool = False,
    synthetic_n: int = 512,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (A, B, is_real) for unpaired training (B is decoupled from A
    at batch time by the loader's random-B transform)."""
    if not synthetic:
        root = os.path.join(data_dir, dataset_name)
        pair = load_unpaired_folders(root, split, height, width)
        if pair is None:
            pair = load_paired_folder(root, split, height, width)
        if pair is not None:
            return pair[0], pair[1], True
    a, b = synthetic_scene_pairs(synthetic_n, height, width, seed)
    # Decorrelate the synthetic domains (unpaired semantics).
    rng = np.random.default_rng(seed + 13)
    return a, b[rng.permutation(len(b))], False


def resize_crop_flip_transform(
    seed: int,
    height: int,
    width: int,
    scale: float = 1.12,
    indices=(0, 1),
):
    """CycleGAN train-time jitter (cyclegan/cyclegan.py:111-117): bicubic
    upscale ~1.12x, random crop back to (H, W), random h-flip. Runs on the
    loader thread through the native host pipeline (tpugan_torch.native
    .augment_batch — PIL-bit-exact bicubic, fused crop/flip in C++, with a
    numpy fallback); crop offsets and flip flags come from the loader's
    seeded numpy Generator either way."""
    from tpugan_torch import native

    up_h, up_w = int(height * scale), int(width * scale)

    def transform(batch, epoch, bidx):
        rng = np.random.default_rng((seed, epoch, bidx, 3))
        out = list(batch)
        for i in indices:
            n = len(out[i])
            ys = rng.integers(0, up_h - height + 1, n)
            xs = rng.integers(0, up_w - width + 1, n)
            flips = rng.random(n) < 0.5
            out[i] = native.augment_batch(
                out[i], (up_h, up_w), (height, width), ys, xs, flips
            )
        return tuple(out)

    return transform

