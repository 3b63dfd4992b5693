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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.in_act_fwd.argtypes = [p, p, p, p, i64, i64, f32, f32, p]
    lib.in_act_fwd.restype = ctypes.c_int
    lib.in_act_bwd.argtypes = [p, p, p, p, p, i64, i64, f32, p]
    lib.in_act_bwd.restype = ctypes.c_int
    lib.adain_fwd.argtypes = [p] * 6 + [i64, i64, f32, p]
    lib.adain_fwd.restype = ctypes.c_int
    lib.adain_bwd.argtypes = [p] * 8 + [i64, i64, p]
    lib.adain_bwd.restype = ctypes.c_int
    lib.mlp_gp_fwd.argtypes = [p] * 12 + [i64] * 4 + [p]
    lib.mlp_gp_fwd.restype = ctypes.c_int
    lib.mlp_gp_bwd.argtypes = [p] * 11 + [i64] * 4 + [p]
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
