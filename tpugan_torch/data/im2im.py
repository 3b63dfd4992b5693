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


def paired_or_synthetic(
    data_dir: str,
    dataset_name: str,
    height: int,
    width: int,
    split: str = "train",
    synthetic: bool = False,
    synthetic_n: int = 512,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (A, B, is_real) for paired training."""
    if not synthetic:
        root = os.path.join(data_dir, dataset_name)
        pair = load_paired_folder(root, split, height, width)
        if pair is not None:
            return pair[0], pair[1], True
        # cyclegan-layout fallback only works as PAIRED data when the two
        # folders align 1:1; otherwise fall through to synthetic pairs.
        pair = load_unpaired_folders(root, split, height, width)
        if pair is not None and len(pair[0]) == len(pair[1]):
            return pair[0], pair[1], True
    a, b = synthetic_scene_pairs(synthetic_n, height, width, seed)
    return a, b, False


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


def load_celeba_attrs(
    root: str, height: int, width: int, attributes: List[str],
    mode: str = "train", limit: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """CelebA with ``list_attr_celeba.txt`` (stargan/datasets.py:12-46), as
    ``tpugan/data/im2im.py:load_celeba_attrs`` reads it: the annotation
    file's last 2000 images are the val split; each image bicubic-resized to
    (height, width); labels are the ``attributes`` columns, '1' -> 1.0, else
    0.0. None without the annotation file or any listed image."""
    ann = os.path.join(root, "list_attr_celeba.txt")
    if not os.path.exists(ann):
        return None
    with open(ann) as f:
        lines = [l.rstrip() for l in f][1:]
    all_attrs = lines[0].split()
    col = [all_attrs.index(a) for a in attributes]
    rows = lines[1:]
    rows = rows[:-2000] if mode == "train" else rows[-2000:]
    if limit:
        rows = rows[:limit]
    from PIL import Image

    imgs, labels = [], []
    for line in rows:
        parts = line.split()
        fp = os.path.join(root, parts[0])
        if not os.path.exists(fp):
            continue
        vals = parts[1:]
        img = Image.open(fp).convert("RGB").resize((width, height), Image.BICUBIC)
        imgs.append(np.asarray(img, np.uint8))
        labels.append([1.0 if vals[c] == "1" else 0.0 for c in col])
    if not imgs:
        return None
    return np.stack(imgs), np.asarray(labels, np.float32)


def synthetic_attr_faces(
    n: int, height: int, width: int, c_dim: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural attribute-conditioned images: each binary attribute
    controls a visible image property (hue of a region), so the attribute
    classifier head has real signal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=(n, c_dim)).astype(np.float32)
    imgs = np.zeros((n, height, width, 3), np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(n):
        base = rng.uniform(40, 90)
        img = np.full((height, width, 3), base, np.float32)
        # Central "face" ellipse.
        cy, cx = height / 2 + rng.normal(0, 2), width / 2 + rng.normal(0, 2)
        mask = ((yy - cy) / (height * 0.3)) ** 2 + (
            (xx - cx) / (width * 0.22)
        ) ** 2 < 1.0
        img[mask] = 180.0
        for a in range(c_dim):
            if labels[i, a] > 0.5:
                band = slice(a * height // max(c_dim, 1),
                             (a + 1) * height // max(c_dim, 1))
                img[band, :, a % 3] += 60.0
        img += rng.normal(0, 5, img.shape)
        imgs[i] = img
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


def celeba_or_synthetic(
    data_dir: str,
    dataset_name: str,
    height: int,
    width: int,
    attributes: List[str],
    mode: str = "train",
    synthetic: bool = False,
    synthetic_n: int = 512,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """stargan's (images, attribute labels, is_real): CelebA from
    ``--data_dir``/``--dataset_name`` when present and not forced synthetic,
    else the procedural attribute faces (seed + 1 for the val split)."""
    if not synthetic:
        got = load_celeba_attrs(os.path.join(data_dir, dataset_name), height, width, attributes,
                                mode=mode)
        if got is not None:
            return got[0], got[1], True
    imgs, labels = synthetic_attr_faces(synthetic_n, height, width, len(attributes),
                                        seed=seed + (0 if mode == "train" else 1))
    return imgs, labels, False


def celeba_images_or_synthetic(
    data_dir: str,
    dataset_name: str,
    height: int,
    width: int,
    mode: str = "train",
    val_tail: int = 4000,
    synthetic: bool = False,
    synthetic_n: int = 512,
    seed: int = 0,
) -> Tuple[np.ndarray, bool]:
    """Plain CelebA-style image folder (no attributes) with the
    context_encoder split rule: last ``val_tail`` files are the val set
    (context_encoder/datasets.py:17-18). Documented deviation: for folders
    with <= val_tail images the reference's slice leaves an EMPTY train
    set; here the tail shrinks to 10% (min 1) so both splits are non-empty
    and never overlap. Falls back to the procedural attr-face images."""
    if not synthetic:
        imgs = _load_folder(os.path.join(data_dir, dataset_name), height, width)
        if imgs is not None and len(imgs) > 0:
            if len(imgs) == 1:
                return imgs, True  # degenerate folder: share the one image
            tail = val_tail
            if len(imgs) <= val_tail:
                tail = max(1, len(imgs) // 10)
                print(
                    f"[tpugan] {dataset_name}: only {len(imgs)} images — "
                    f"val split shrunk to the last {tail} (reference slice "
                    f"would leave an empty train set)"
                )
            # ``val_tail`` 0 (srgan, esrgan): every image trains. The JAX
            # package's ``imgs[:-0]`` leaves none (ROADMAP 3.4).
            cut = len(imgs) - tail
            return (imgs[:cut] if mode == "train" else imgs[cut:]), True
    imgs, _ = synthetic_attr_faces(
        synthetic_n, height, width, 5,
        seed=seed + (0 if mode == "train" else 1),
    )
    return imgs, False


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


def joint_hflip_transform(seed: int, prob: float = 0.5, indices=(0, 1)):
    """Loader host_transform: flip the SAME samples in both domains (the
    paired datasets' joint np-slice flip, pix2pix/datasets.py:26-28)."""

    def transform(batch, epoch, bidx):
        rng = np.random.default_rng((seed, epoch, bidx, 1))
        flips = rng.random(len(batch[0])) < prob
        out = list(batch)
        for i in indices:
            arr = out[i].copy()
            arr[flips] = arr[flips, :, ::-1]
            out[i] = arr
        return tuple(out)

    return transform
