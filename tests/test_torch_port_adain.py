"""The port's AdaIN against the JAX package.

``AdaIN`` on CPU tensors runs ``adain_fwd_ref``/``adain_bwd_ref``, the plain
versions of the CUDA pair; here they are held against ``adain_pallas`` in
Pallas interpret mode and against ``tpugan.nn.style.adain`` (the XLA path),
forward and VJP with respect to x, weight and bias. Inputs are made with numpy
from a seed; NHWC for JAX, NCHW for torch, weight and bias (B, C) on both.

Tolerances, float32 on both sides with sums in different orders: the forward
1e-5 absolute on outputs of unit scale; the gradients 2e-4 absolute and 1e-4
relative, as ``tests/test_pallas_kernels.py`` holds ``adain_pallas`` to XLA
(dw and dbias are sums over a plane of H*W terms). In bf16 both sides are
held to the float64 truth of the same bf16 values, as
``tests/test_torch_port_bf16.py`` holds the plain bf16 versions: the port's
largest error no larger than JAX's plus one bf16 ulp of the truth's largest
magnitude.

Also here, without CUDA: the wrappers' check of w and bias
(``instance_norm.per_plane_strides``: x's dtype, shape (B, C), a row's
entries adjacent, rows any stride apart), and that the MUNIT decoder hands
AdaIN one dtype in float32 and in bf16, since the kernels refuse a mixed
call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpugan.nn.style import adain as adain_xla
from tpugan.ops.pallas_kernels import adain_pallas
from tpugan_torch.nn import layers as layers_t
from tpugan_torch.nn.style import MunitDecoder
from tpugan_torch.ops import adain as ta
from tpugan_torch.ops.instance_norm import per_plane_strides

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


# (map shape, per-plane tensor, what per_plane_strides gives or raises).
PER_PLANE_CASES = {
    "contiguous": ((3, 16, 2, 2), lambda: torch.zeros(3, 16), 16),
    "row slice of (B, 4C)": ((3, 16, 2, 2), lambda: torch.zeros(3, 64)[:, 16:32], 64),
    "one sample's row slice": ((1, 16, 2, 2), lambda: torch.zeros(1, 64)[:, 48:64], 64),
    "rows broadcast": ((3, 16, 2, 2), lambda: torch.zeros(1, 16).expand(3, 16), 0),
    "one channel, any column stride": ((3, 1, 2, 2), lambda: torch.zeros(3, 8)[:, 3::8], 8),
    "column slice of (4C, B), transposed": ((3, 16, 2, 2), lambda: torch.zeros(64, 3)[:16].t(),
                                           ValueError),
    "every other column": ((3, 16, 2, 2), lambda: torch.zeros(3, 32)[:, ::2], ValueError),
    "shape (C, B)": ((3, 16, 2, 2), lambda: torch.zeros(16, 3), ValueError),
    "bf16 w, float32 map": ((3, 16, 2, 2), lambda: torch.zeros(3, 16, dtype=torch.bfloat16),
                            TypeError),
    "float32 w, bf16 map": ((3, 16, 2, 2), lambda: torch.zeros(3, 16), TypeError),
}


@pytest.mark.parametrize("case", sorted(PER_PLANE_CASES))
def test_per_plane_strides_takes_rows_apart_and_refuses_the_rest(case):
    """What the AdaIN kernels read in place, checked in plain Python: w and
    bias of the map's dtype, shape (B, C), a row's entries adjacent; the row
    stride is what the kernel gets as ldw (ldb)."""
    shape, make, want = PER_PLANE_CASES[case]
    dtype = torch.bfloat16 if case == "float32 w, bf16 map" else torch.float32
    x = torch.zeros(shape, dtype=dtype)
    t = make()
    bias = torch.zeros(shape[:2], dtype=t.dtype)
    if isinstance(want, int):
        assert per_plane_strides("adain_fwd", x, t, bias) == [want, shape[1]]
        assert per_plane_strides("adain_fwd", x, bias, t) == [shape[1], want]
    else:
        for args in ((t, bias), (bias, t)):
            with pytest.raises(want):
                per_plane_strides("adain_fwd", x, *args)


def _truth_rule(port, jax_out, truth):
    """The port's largest error against the float64 truth is no larger than
    JAX's plus one bf16 ulp of the truth's largest magnitude."""
    ulp = float(chip_smoke.bf16_ulp(torch.tensor(float(np.abs(truth).max()))))
    err_t = np.abs(port - truth).max()
    err_j = np.abs(jax_out - truth).max()
    assert err_t <= err_j + ulp, (err_t, err_j, ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_slices_match_contiguous_copies_and_jax(dtype):
    """``AdaIN.apply`` on w and bias as column slices of a (B, 4C) tensor
    gives the bits of the same call on contiguous copies, y and the (B, 4C)
    gradient alike, and agrees with JAX's XLA ``adain`` on the same slices:
    at the float32 tolerances in float32, by the float64-truth rule in
    bf16."""
    b, c = 3, 16
    td = getattr(torch, dtype)
    x, _, _, g = _inputs((b, 5, 4, c), seed=9)
    params = np.random.default_rng(10).normal(0.5, 0.5, (b, 4 * c)).astype(np.float32)
    xt = _nchw(x).to(td).requires_grad_(True)
    gt = _nchw(g).to(td)
    pt = torch.from_numpy(params).to(td).requires_grad_(True)
    assert not pt[:, c:2 * c].is_contiguous()
    y = ta.AdaIN.apply(xt, pt[:, c:2 * c], pt[:, :c], 1e-5)
    dx, dp = torch.autograd.grad(y, (xt, pt), gt)

    wc = pt.detach()[:, c:2 * c].contiguous().requires_grad_(True)
    bc = pt.detach()[:, :c].contiguous().requires_grad_(True)
    y_c = ta.AdaIN.apply(xt, wc, bc, 1e-5)
    dx_c, dw_c, db_c = torch.autograd.grad(y_c, (xt, wc, bc), gt)
    assert torch.equal(y, y_c) and torch.equal(dx, dx_c)
    assert torch.equal(dp[:, c:2 * c], dw_c) and torch.equal(dp[:, :c], db_c)
    assert not dp[:, 2 * c:].any()
    assert {t.dtype for t in (y, dx, dp)} == {td}

    jd = getattr(jnp, dtype)
    xj = jnp.asarray(_nhwc(xt.detach().float()), jd)
    pj = jnp.asarray(pt.detach().float().numpy(), jd)
    y_j, vjp = jax.vjp(lambda v, p: adain_xla(v, p[:, c:2 * c], p[:, :c], 1e-5), xj, pj)
    dx_j, dp_j = vjp(jnp.asarray(_nhwc(gt.float()), jd))
    got = (_nhwc(y.detach().float()), _nhwc(dx.float()), dp.float().numpy())
    want = tuple(np.asarray(a, np.float32) for a in (y_j, dx_j, dp_j))
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
        for name, a, b_ in zip(("dx", "dparams"), got[1:], want[1:]):
            np.testing.assert_allclose(a, b_, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
        return
    x64, g64, p64 = xt.detach().double(), gt.double(), pt.detach().double()
    y64, m64, r64 = ta.adain_fwd_ref(x64, p64[:, c:2 * c], p64[:, :c], 1e-5)
    dx64, dw64, db64 = ta.adain_bwd_ref(g64, x64, p64[:, c:2 * c], m64, r64)
    dp64 = torch.zeros_like(p64)
    dp64[:, :c], dp64[:, c:2 * c] = db64, dw64
    truths = (_nhwc(y64), _nhwc(dx64), dp64.numpy())
    for port, jx, truth in zip(got, want, truths):
        _truth_rule(port.astype(np.float64), jx.astype(np.float64), truth)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_munit_decoder_hands_adain_one_dtype(monkeypatch, dtype):
    """Every AdaIN of the MUNIT decoder gets x, w and bias of one dtype,
    float32 or bf16 under ``--dtype bfloat16`` (the style MLP's Linear and
    the convolutions compute in it), w and bias as column slices of the
    MLP's (B, 4C x blocks) output: no ported path hands the kernels a mixed
    call, which they refuse."""
    seen = []
    real = ta.adain_fwd

    def spy(x, w, b, eps):
        seen.append((x.dtype, w.dtype, b.dtype, w.stride(0), b.stride(0)))
        return real(x, w, b, eps)

    monkeypatch.setattr(ta, "adain_fwd", spy)
    layers_t.set_default_compute_dtype(dtype)
    try:
        gen = torch.Generator().manual_seed(0)
        dec = MunitDecoder(dim=4, n_residual=2, n_upsample=1, style_dim=8, generator=gen)
        y = dec(torch.randn(2, 8, 6, 6, generator=gen), torch.randn(2, 8, 1, 1, generator=gen))
    finally:
        layers_t.set_default_compute_dtype(None)
    want = dtype or torch.float32
    # 2 blocks x 2 AdaINs, C = 8: slices of the MLP's (B, 4C x 2) output
    assert seen == [(want, want, want, 64, 64)] * 4
    assert torch.isfinite(y.float()).all()
