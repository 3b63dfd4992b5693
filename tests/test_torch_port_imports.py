"""The port stands alone: no module of ``tpugan_torch``, and not
``chip_smoke.py``, imports JAX or any module of the JAX package ``tpugan``.
The port keeps its own copies of the JAX-free helpers it needs; its copy of
the native host pipeline gathers what the JAX package's does."""

import os
import pkgutil
import subprocess
import sys

import numpy as np

import tpugan_torch
from tpugan.native import gather as gather_j
from tpugan_torch.native import gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = ["tpugan_torch"]
    for info in pkgutil.walk_packages(tpugan_torch.__path__, "tpugan_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_tpugan():
    names = _port_modules()
    assert {"tpugan_torch.native", "tpugan_torch.models.wgan_gp", "tpugan_torch.models.wgan",
            "tpugan_torch.ops.mlp_gp", "tpugan_torch.utils.config"} <= set(names)
    assert {f"tpugan_torch.models.{name}" for name in (
        "gan", "wgan_div", "dragan", "cgan", "acgan", "sgan", "infogan", "pix2pix", "discogan",
        "dualgan", "context_encoder", "ccgan", "stargan", "unit", "pixelda", "cogan", "bgan",
        "softmax_gan", "relativistic_gan", "ebgan", "began", "aae", "cluster_gan", "bicyclegan",
        "srgan", "esrgan", "test_on_image")} <= set(names)
    code = (
        "import importlib, sys\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'tpugan' or m.startswith('tpugan.'))\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code, *names, "chip_smoke"],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout, proc.stdout


def test_native_gather_matches_the_jax_package():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (20, 7, 5, 3), dtype=np.uint8)
    idx = rng.permutation(20)[:9]
    got = gather(src, idx)
    assert got.dtype == np.uint8 and np.array_equal(got, gather_j(src, idx))
    assert np.array_equal(got, src[idx])


def test_native_numpy_path_does_the_same_host_work(monkeypatch):
    from tpugan_torch import native

    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, (6, 4, 5, 3), dtype=np.uint8)
    idx = np.array([5, 0, 3])
    built = (native.gather(src, idx), native.hflip(src))
    monkeypatch.setattr(native, "_get", lambda: None)
    assert not native.available()
    for got, want in zip((native.gather(src, idx), native.hflip(src)), built):
        assert np.array_equal(got, want)


def test_native_copy_is_byte_identical():
    with open(os.path.join(REPO, "csrc", "host_pipeline.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "tpugan_torch", "native", "host_pipeline.cpp"), "rb") as f:
        assert f.read() == want
