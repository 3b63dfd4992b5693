"""Native (C++) host-pipeline bindings: the port's own copy of
``tpugan/native/__init__.py``.

``host_pipeline.cpp`` beside this file is a byte-identical copy of the JAX
package's ``csrc/host_pipeline.cpp``: batch gather, PIL-convention bicubic
resampling, a fused resize->crop->flip augmenter and hflip, bound here with
ctypes. It is compiled with g++ at first use into
``build/tpugan_torch/host_pipeline_<source hash>.so`` in the checkout.

Every entry point keeps the numpy path of the JAX module for a host without
a toolchain. That path does the same host work with the same random draws;
it is not a device fallback. ``available()`` says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_pipeline.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "tpugan_torch")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    so = os.path.join(BUILD_DIR, "host_pipeline_%s.so" % tag)
    if not os.path.exists(so):
        tmp = so + ".tmp.%d" % os.getpid()
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            "-march=native", _SRC, "-o", tmp,
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
            os.replace(tmp, so)
        except Exception:
            try:
                # Retry without -march=native (unsupported on some hosts).
                cmd.remove("-march=native")
                subprocess.run(
                    cmd, check=True, capture_output=True, timeout=120
                )
                os.replace(tmp, so)
            except Exception:
                return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.tg_gather_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.tg_resize_bicubic_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.tg_augment_batch_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.tg_hflip_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tg_version.restype = ctypes.c_int
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _build()
    return _lib


def available() -> bool:
    """True when the compiled native library is active."""
    return _get() is not None


def _c(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr)


def gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]] — native batch assembly for uint8 datasets."""
    lib = _get()
    if lib is None or src.dtype != np.uint8:
        return src[idx]
    src = _c(src)
    idx64 = _c(idx.astype(np.int64))
    out = np.empty((len(idx64),) + src.shape[1:], np.uint8)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    lib.tg_gather_u8(
        src.ctypes.data, idx64.ctypes.data, out.ctypes.data,
        len(idx64), row,
    )
    return out


def _resize_pil_fallback(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    from PIL import Image

    out = np.empty((src.shape[0], oh, ow, src.shape[3]), np.uint8)
    for i in range(src.shape[0]):
        im = src[i, :, :, 0] if src.shape[3] == 1 else src[i]
        r = np.asarray(
            Image.fromarray(im).resize((ow, oh), Image.BICUBIC)
        )
        out[i] = r[..., None] if src.shape[3] == 1 else r
    return out


def resize_bicubic(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Batched PIL-convention bicubic resize, [n,h,w,c] u8 -> [n,oh,ow,c]."""
    assert src.ndim == 4 and src.dtype == np.uint8
    lib = _get()
    if lib is None:
        return _resize_pil_fallback(src, oh, ow)
    src = _c(src)
    n, h, w, c = src.shape
    out = np.empty((n, oh, ow, c), np.uint8)
    lib.tg_resize_bicubic_u8(
        src.ctypes.data, n, h, w, c, out.ctypes.data, oh, ow
    )
    return out


def augment_batch(
    src: np.ndarray,
    resize_hw: tuple,
    crop_hw: tuple,
    oy: np.ndarray,
    ox: np.ndarray,
    flip: np.ndarray,
) -> np.ndarray:
    """Fused bicubic-resize -> crop@(oy,ox) -> optional hflip per image.

    The cyclegan-style train augmentation (cyclegan/cyclegan.py:111-117)
    with caller-supplied randomness (offsets/flags from the loader's seeded
    numpy Generator, so native and fallback paths share one RNG stream).
    """
    assert src.ndim == 4 and src.dtype == np.uint8
    rh, rw = resize_hw
    ch, cw = crop_hw
    n, h, w, c = src.shape
    lib = _get()
    if lib is not None:
        src = _c(src)
        oy32 = _c(oy.astype(np.int32))
        ox32 = _c(ox.astype(np.int32))
        fl = _c(flip.astype(np.uint8))
        out = np.empty((n, ch, cw, c), np.uint8)
        lib.tg_augment_batch_u8(
            src.ctypes.data, n, h, w, c, rh, rw, ch, cw,
            oy32.ctypes.data, ox32.ctypes.data, fl.ctypes.data,
            out.ctypes.data,
        )
        return out
    big = _resize_pil_fallback(src, rh, rw)
    out = np.empty((n, ch, cw, c), np.uint8)
    for i in range(n):
        win = big[i, oy[i] : oy[i] + ch, ox[i] : ox[i] + cw]
        out[i] = win[:, ::-1] if flip[i] else win
    return out


def hflip(src: np.ndarray) -> np.ndarray:
    """Batched horizontal flip, [n,h,w,c] u8."""
    assert src.ndim == 4 and src.dtype == np.uint8
    lib = _get()
    if lib is None:
        return src[:, :, ::-1].copy()
    src = _c(src)
    n, h, w, c = src.shape
    out = np.empty_like(src)
    lib.tg_hflip_u8(src.ctypes.data, n, h, w, c, out.ctypes.data)
    return out
