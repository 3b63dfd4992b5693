"""Build and load the port's CUDA kernels.

``tpugan_torch/csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, at first use, under
``build/tpugan_torch/`` in the checkout: one ``nvcc -c`` per source, all
started together, then one link. The file name carries a content hash
of the sources (as ``tpugan/native`` does for the host pipeline), so an edited
kernel is rebuilt and an unchanged one is not. The library is loaded with
ctypes. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpugan_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class BuildInfo:
    """What the last :func:`library` call did: the library path, whether it
    was compiled in this process, the seconds it took and nvcc's output
    (ptxas prints each kernel's registers and spills there)."""

    path = ""
    compiled = False
    seconds = 0.0
    log = ""


def _sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return found


def _run(cmd: list) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen) -> str:
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed (rc=%d): %s\n%s" % (proc.returncode, " ".join(proc.args), out)
        )
    return out


def _compile(srcs: list, so: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = "%s.tmp.%d" % (so, os.getpid())
    objs = ["%s.%d.o" % (tag, i) for i in range(len(srcs))]
    procs = [_run([nvcc, *NVCC_FLAGS, "-c", "-o", o, src]) for src, o in zip(srcs, objs)]
    try:
        log = "".join(_wait(p) for p in procs)
        log += _wait(_run([nvcc, *NVCC_FLAGS, "-shared", "-o", tag, *objs]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tag, so)
    return log


class LaunchPlan(ctypes.Structure):
    """``instance_norm.cu``'s ``LaunchPlan``, passed by pointer."""

    _fields_ = [("planes", ctypes.c_int64), ("hw", ctypes.c_int64), ("group", ctypes.c_int32),
                ("slice", ctypes.c_int32), ("held", ctypes.c_int32), ("threads", ctypes.c_int32)]


class GpProduct(ctypes.Structure):
    """``mlp_gp.cu``'s ``GpProduct``: one product's share of a launch."""

    _fields_ = [(name, ctypes.c_int32) for name in ("ks", "kc", "rows", "tiles_m", "tiles_n",
                                                     "ctas")]


class GpPlan(ctypes.Structure):
    """``mlp_gp.cu``'s ``GpPlan``, passed by pointer."""

    _fields_ = [("b", ctypes.c_int64), ("n0", ctypes.c_int64), ("n1", ctypes.c_int64),
                ("n2", ctypes.c_int64), ("pdl", ctypes.c_int32), ("bn", ctypes.c_int32 * 4),
                ("grid", ctypes.c_int32 * 4), ("smem", ctypes.c_int32 * 4),
                ("prod", GpProduct * 4)]


def check_tensors(name: str, dev: int, *ts, dtype: torch.dtype = torch.float32) -> None:
    """One pass over the tensors: each of ``dtype``, contiguous, on CUDA
    device dev."""
    for t in ts:
        if not (t.is_cuda and t.dtype is dtype and t.is_contiguous()
                and t.get_device() == dev):
            _refuse(name, dev, t, dtype)


def _refuse(name: str, dev: int, t, dtype: torch.dtype) -> None:
    if not t.is_cuda or t.get_device() != dev:
        raise ValueError(f"{name}: a tensor on {t.device}, expected all on cuda:{dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype} here")
    raise ValueError(f"{name}: non-contiguous input of shape {tuple(t.shape)}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
    plan = ctypes.POINTER(LaunchPlan)
    # (x, w, b, y, mean, rstd, eps, slope, C, ldw, ldb, plan, stream)
    lib.in_act_fwd.argtypes = [p] * 6 + [f32, f32, i64, i64, i64, plan, p]
    lib.in_act_fwd.restype = ctypes.c_int
    # (g, x, w, mean, rstd, dx, dw, db, slope, C, ldw, plan, stream)
    lib.in_act_bwd.argtypes = [p] * 8 + [f32, i64, i64, plan, p]
    lib.in_act_bwd.restype = ctypes.c_int
    lib.in_act_fwd_bf16.argtypes = lib.in_act_fwd.argtypes
    lib.in_act_fwd_bf16.restype = ctypes.c_int
    lib.in_act_bwd_bf16.argtypes = lib.in_act_bwd.argtypes
    lib.in_act_bwd_bf16.restype = ctypes.c_int
    gp_plan = ctypes.POINTER(GpPlan)
    lib.mlp_gp_fwd.argtypes = [p] * 11 + [gp_plan, p]
    lib.mlp_gp_fwd.restype = ctypes.c_int
    lib.mlp_gp_bwd.argtypes = [p] * 11 + [gp_plan, p]
    lib.mlp_gp_bwd.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if its sources changed."""
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, "libtpugan_torch_%s.so" % digest.hexdigest()[:16])
    t0 = time.perf_counter()
    BuildInfo.compiled = not os.path.exists(so)
    BuildInfo.log = _compile(srcs, so) if BuildInfo.compiled else ""
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.path = so
    return _bind(ctypes.CDLL(so))
