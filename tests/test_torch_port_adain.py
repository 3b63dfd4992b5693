"""The port's AdaIN against the JAX package.

``AdaIN`` on CPU tensors runs ``adain_fwd_ref``/``adain_bwd_ref``, the plain
versions of the CUDA pair; here they are held against ``adain_pallas`` in
Pallas interpret mode and against ``tpugan.nn.style.adain`` (the XLA path),
forward and VJP with respect to x, weight and bias. Inputs are made with numpy
from a seed; NHWC for JAX, NCHW for torch, weight and bias (B, C) on both.

Tolerances, float32 on both sides with sums in different orders: the forward
1e-5 absolute on outputs of unit scale; the gradients 2e-4 absolute and 1e-4
relative, as ``tests/test_pallas_kernels.py`` holds ``adain_pallas`` to XLA
(dw and dbias are sums over a plane of H*W terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.nn.style import adain as adain_xla
from tpugan.ops.pallas_kernels import adain_pallas
from tpugan_torch.ops import adain as ta

FWD_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-4

# NHWC shapes: the JAX kernel test's (B=2, 8x8, C=128), a ragged 7x5 map
# (the kernel's scalar path on the card), and 1x1 planes (x̂ = 0).
SHAPES = {"8x8x128": (2, 8, 8, 128), "ragged_7x5": (2, 7, 5, 6), "hw_1": (2, 1, 1, 4)}
JAX_FNS = {
    "pallas": lambda x, w, b: adain_pallas(x, w, b, 1e-5, True),
    "xla": lambda x, w, b: adain_xla(x, w, b),
}


def _inputs(shape, seed, zero_w=False):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[3]
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    w = rng.normal(1.0, 0.3, (b, c)).astype(np.float32)
    if zero_w:  # zeros and negatives
        w[:, ::3] = 0.0
        w[:, 1::3] *= -1.0
    bias = rng.normal(0.0, 0.3, (b, c)).astype(np.float32)
    g = rng.normal(0.0, 1.0, shape).astype(np.float32)
    return x, w, bias, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_fwd_vjp(fn, x, w, bias, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    return (np.asarray(y), *(np.asarray(d) for d in vjp(jnp.asarray(g))))


def _torch_fwd_vjp(x, w, bias, g):
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(w.copy()).requires_grad_(True)
    bt = torch.from_numpy(bias.copy()).requires_grad_(True)
    y = ta.adain(xt, wt, bt)
    (y * _nchw(g)).sum().backward()
    return _nhwc(y), _nhwc(xt.grad), wt.grad.numpy(), bt.grad.numpy()


def _assert_match(got, want):
    y_t, dx_t, dw_t, db_t = got
    y_j, dx_j, dw_j, db_j = want
    np.testing.assert_allclose(y_t, y_j, atol=FWD_ATOL)
    for name, a, b in (("dx", dx_t, dx_j), ("dw", dw_t, dw_j), ("dbias", db_t, db_j)):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("ref", sorted(JAX_FNS))
@pytest.mark.parametrize("case", [*SHAPES, "w_with_zeros"])
def test_matches_jax(ref, case):
    shape = SHAPES.get(case, SHAPES["8x8x128"])
    x, w, bias, g = _inputs(shape, seed=4, zero_w=case == "w_with_zeros")
    _assert_match(_torch_fwd_vjp(x, w, bias, g), _jax_fwd_vjp(JAX_FNS[ref], x, w, bias, g))


def test_one_pixel_planes_give_bias_and_zero_dx():
    x, w, bias, g = _inputs(SHAPES["hw_1"], seed=2)
    y, dx, dw, db = _torch_fwd_vjp(x, w, bias, g)
    np.testing.assert_array_equal(y.reshape(w.shape), bias)
    np.testing.assert_array_equal(dx, 0.0)
    np.testing.assert_array_equal(dw, 0.0)
    np.testing.assert_array_equal(db, g.reshape(w.shape))


def test_strided_weight_and_bias_slices():
    """w and bias sliced out of one (B, 4C) tensor, as the AdaIN residual
    block takes them from the style MLP ([bias1, weight1, ...]): strided at
    B > 1, and the gradient reaches the slices of the wide tensor."""
    b, c = 3, 16
    x, _, _, g = _inputs((b, 5, 4, c), seed=7)
    params = np.random.default_rng(8).normal(0.5, 0.5, (b, 4 * c)).astype(np.float32)

    def block_j(xj, pj):
        return adain_pallas(xj, pj[:, c:2 * c], pj[:, :c], 1e-5, True)

    y_j, vjp = jax.vjp(block_j, jnp.asarray(x), jnp.asarray(params))
    dx_j, dp_j = vjp(jnp.asarray(g))

    xt = _nchw(x).requires_grad_(True)
    pt = torch.from_numpy(params).requires_grad_(True)
    w_t, b_t = pt[:, c:2 * c], pt[:, :c]
    assert not w_t.is_contiguous() and not b_t.is_contiguous()
    y = ta.adain(xt, w_t, b_t)
    (y * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), atol=FWD_ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(dp_j), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert not pt.grad[:, 2 * c:].any()  # the second layer's slices took no gradient


def test_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(2, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    b = torch.randn(2, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: ta.AdaIN.apply(*a, 1e-5), (x, w, b))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ta.reset_launch_counts()
    x, w, bias, g = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 8), seed=5))
    x = x.permute(0, 3, 1, 2).contiguous()
    g = g.permute(0, 3, 1, 2).contiguous()
    got = ta.adain_fwd(x, w, bias, 1e-5)
    want = ta.adain_fwd_ref(x, w, bias, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, mean, rstd = got
    assert mean.shape == (16,) and rstd.shape == (16,)  # B*C planes
    dx, dw, db = ta.adain_bwd(g, x, w, mean, rstd)
    assert dx.shape == x.shape and dw.shape == db.shape == (2, 8)
    assert (ta.adain_fwd_launches, ta.adain_bwd_launches) == (0, 0)


def test_autograd_function_saves_x_w_and_stats():
    """Residuals are (x, w, mean, rstd), as the Pallas VJP keeps them."""
    x, w, bias, _ = _inputs((2, 5, 5, 3), seed=6)
    xt = _nchw(x).requires_grad_(True)
    y = ta.adain(xt, torch.from_numpy(w), torch.from_numpy(bias))
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [tuple(xt.shape), (2, 3), (6,), (6,)]
