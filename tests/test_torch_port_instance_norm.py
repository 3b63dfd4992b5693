"""The port's instance-norm pair against the JAX package's Pallas kernels.

``InstanceNormAct`` on CPU tensors runs ``in_act_fwd_ref``/``in_act_bwd_ref``,
the plain versions of the CUDA kernels; here they are held against
``instance_norm_pallas``, ``instance_norm_act_pallas`` and
``instance_norm_act_tiled`` in Pallas interpret mode, forward and gradient.
Inputs are made with numpy from a seed; NHWC for JAX, NCHW for torch.

Tolerances: both sides compute in float32 with sums in different orders.
A centred mean/variance over H*W of unit-scale data rounds to ~1e-6, so the
forward is held to 1e-5 absolute and the gradient to 1e-4 absolute. At an
offset of 100 the inputs themselves carry ulp(100) ~ 8e-6 of rounding per
element, which the normalisation scales by 1/std: 1e-4 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.ops.pallas_kernels import (
    instance_norm_act_pallas,
    instance_norm_act_tiled,
    instance_norm_pallas,
)
from tpugan_torch.ops import instance_norm as tin
from tpugan_torch.utils import tracing

SLOPES = (0.0, 0.2, 1.0)


def _x(shape=(2, 8, 8, 128), seed=0, offset=0.0):
    """NHWC float32 with unit-ish spread around ``offset``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 1.0, shape) + offset).astype(np.float32)


def _g(shape, seed):
    return np.random.default_rng(seed + 1000).normal(0.0, 1.0, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_fn(kind, slope):
    if kind == "plain":
        return lambda x: instance_norm_pallas(x, 1e-5, True)
    if kind == "fused":
        return lambda x: instance_norm_act_pallas(x, 1e-5, slope, True)
    return lambda x: instance_norm_act_tiled(x, 64, 1e-5, slope, True)


def _torch_fwd_bwd(x_nhwc, g_nhwc, slope):
    x = _nchw(x_nhwc).requires_grad_(True)
    y = tin.instance_norm_act(x, slope)
    (y * _nchw(g_nhwc)).sum().backward()
    return _nhwc(y), _nhwc(x.grad)


def _jax_fwd_bwd(fn, x_nhwc, g_nhwc):
    x, g = jnp.asarray(x_nhwc), jnp.asarray(g_nhwc)
    y, vjp = jax.vjp(fn, x)
    return np.asarray(y), np.asarray(vjp(g)[0])


@pytest.mark.parametrize(
    "kind,slope",
    [("plain", 1.0)] + [(k, s) for k in ("fused", "tiled") for s in SLOPES],
)
def test_matches_pallas_kernels(kind, slope):
    """Forward and VJP of every TPU kernel the pair replaces (plain IN is
    slope 1)."""
    shape = (2, 16, 16, 128) if kind == "tiled" else (2, 8, 8, 128)
    x, g = _x(shape, seed=3), _g(shape, seed=3)
    y_j, dx_j = _jax_fwd_bwd(_jax_fn(kind, slope), x, g)
    y_t, dx_t = _torch_fwd_bwd(x, g, slope)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5)
    np.testing.assert_allclose(dx_t, dx_j, atol=1e-4)


@pytest.mark.parametrize("offset", [10.0, 100.0])
@pytest.mark.parametrize("slope", SLOPES)
def test_large_offset_against_tiled(offset, slope):
    """The centred variance does not cancel at mean = 100 * std, the case
    ``tests/test_pallas_kernels.py`` pins for the tiled kernel."""
    shape = (2, 16, 16, 128)
    x, g = _x(shape, seed=9, offset=offset), _g(shape, seed=9)
    y_j, dx_j = _jax_fwd_bwd(_jax_fn("tiled", slope), x, g)
    y_t, dx_t = _torch_fwd_bwd(x, g, slope)
    np.testing.assert_allclose(y_t, y_j, atol=1e-4)
    np.testing.assert_allclose(dx_t, dx_j, atol=1e-4)
    # And against float64 directly: the port is not the one that drifts.
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2), keepdims=True)
    xh = (x64 - mean) / np.sqrt(x64.var(axis=(1, 2), keepdims=True) + 1e-5)
    np.testing.assert_allclose(y_t, np.where(xh >= 0, xh, slope * xh), atol=1e-4)


def test_gradient_at_exact_zero_is_one():
    """The activation's gradient uses the mask xh >= 0, so it is 1 where xh
    is exactly 0, as JAX's ``where`` gives (F.leaky_relu would give slope)."""
    slope = 0.2
    x = torch.tensor([-1.0, 0.0, 1.0]).reshape(1, 1, 1, 3).requires_grad_(True)
    tin.instance_norm_act(x, slope).sum().backward()  # xh = [-a, 0, a]

    def dx_with(mask):
        xh = np.array([-1.0, 0.0, 1.0]) * (1.0 / np.sqrt(2.0 / 3.0 + 1e-5))
        gh = np.asarray(mask)
        return (gh - gh.mean() - xh * (gh * xh).mean()) / np.sqrt(2.0 / 3.0 + 1e-5)

    got = x.grad.flatten().numpy()
    np.testing.assert_allclose(got, dx_with([slope, 1.0, 1.0]), atol=1e-6)
    assert not np.allclose(got, dx_with([slope, slope, 1.0]), atol=1e-3)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tracing.reset()
    x = _nchw(_x((1, 4, 4, 8), seed=5)).requires_grad_(True)
    tin.instance_norm(x).sum().backward()
    assert (tracing.counts["in.fwd"], tracing.counts["in.bwd"]) == (0, 0)
    y, mean, rstd = tin.in_act_fwd(x.detach(), 1e-5, 0.2)
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x.detach(), 1e-5, 0.2)
    assert torch.equal(y, y_r) and torch.equal(mean, mean_r) and torch.equal(rstd, rstd_r)
    assert mean.shape == (8,) and rstd.shape == (8,)  # B*C planes


def test_autograd_function_saves_stats_not_output():
    """Residuals are (x, mean, rstd), as the Pallas VJP keeps them."""
    x = _nchw(_x((2, 3, 5, 5), seed=6)).requires_grad_(True)
    y = tin.instance_norm_act(x, 0.0)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3
    assert saved[0].shape == x.shape and saved[1].shape == (10,) and saved[2].shape == (10,)


def test_ragged_hw_matches_float64():
    """H*W not a multiple of 4 (the kernel's scalar path on the card)."""
    x = _x((2, 7, 7, 3), seed=7)
    y_t, _ = _torch_fwd_bwd(x, _g(x.shape, 7), 0.2)
    x64 = x.astype(np.float64)
    xh = (x64 - x64.mean(axis=(1, 2), keepdims=True)) / np.sqrt(
        x64.var(axis=(1, 2), keepdims=True) + 1e-5
    )
    np.testing.assert_allclose(y_t, np.where(xh >= 0, xh, 0.2 * xh), atol=1e-5)
