"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the launch counts of one CycleGAN step, one WGAN-GP critic step
and one MUNIT step; and one DCGAN step at 64px on the card against the same
step on the CPU, and one step of each of gan, wgan_div, dragan, cgan, acgan,
sgan and infogan at its reference configuration likewise, and of pix2pix,
discogan, dualgan, context_encoder and ccgan, with their IN launches; the IN
pair at every site of the stargan, unit and pixelda paths, their steps'
launches, and stargan's tracked IN on the card against the CPU; one step of
began and one full_step of cluster_gan (``--wass_flag``) on the card against
the CPU, and began's replayed steps, its equilibrium term k included,
against eager ones.

The bf16 forms of the IN pair and AdaIN (``--dtype bfloat16``) against
their plain bf16 versions at the same shapes, within one bf16 ulp plus the
float32 tolerances (``chip_smoke.py``), and one bf16 CycleGAN step on the
card against the same bf16 step on the CPU.

These need a CUDA device and skip without one. Data parallelism: one
DCGAN step on two gloo ranks sharing the card against one process. The
fused dispatch: DCGAN
steps (K = 3) and WGAN-GP schedule units (K = 2) replayed from a CUDA graph
against the same eager steps, the generator's state after them, the GP
kernels a replayed unit launches, and the trainers' fused ``main`` against
the unfused one. The file imports no JAX, so
it also runs where JAX is not installed; there, skip the JAX-importing
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels_gpu.py

Tolerances as in ``chip_smoke.py``: fp32 with sums in different orders,
1e-5 absolute on y and 1e-4 of the largest |dx| on dx for instance norm; for
the GP pair 1e-5 of the largest |g| on g and t, and 1e-4 of the largest
entry on each weight gradient; for AdaIN 1e-5 * max(1, max|w|) absolute on y
and 1e-4 of the largest |.| on each of dx, dw and dbias. The DCGAN step,
fp32 with TF32 off on the card (cuDNN and cuBLAS against the CPU's kernels,
sums in different orders): losses 1e-4 relative, images 1e-4 absolute,
gradients 1e-3 relative plus 1e-3 of the module's largest (the generator's
gradients come back through the discriminator's N(0, 0.02) weights, at
about 1e-4 of the discriminator's, and cuDNN's FFT and Winograd gradients
round relative to a whole map: measured up to 6e-4 of the generator's
largest), parameters after Adam 1e-5 absolute where the gradient is above
that floor and above 100x Adam's eps of 1e-8 (below that, the first update
lr*g/(|g|+eps) turns the gradient's rounding into a share of lr), and 2*lr
elsewhere, running statistics 1e-4 relative and 1e-5 absolute. The other
trainers' steps: the same tolerances, with the gradient floors of
``STEP_FLOORS`` by optimizer (the test prints each measured card-CPU
difference as a share of the largest gradient).
"""

import pytest
import torch

from tpugan_torch.ops import adain as ta
from tpugan_torch.ops import instance_norm as tin
from tpugan_torch.ops import mlp_gp as gp
from tpugan_torch.utils import tracing

pytestmark = pytest.mark.gpu


def launches(*names) -> tuple:
    """The port's counters ``names`` (``tracing.counts``), in order."""
    return tuple(tracing.counts[n] for n in names)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Both regimes of ``instance_norm.plan`` and their boundaries: a warp a
# plane at 16x16, 8x8, 2x2 and 1x7 (regime A); slices in shared memory at
# 32x32 and 31x31 (scalar fill), on clusters of 2 (128x128 backward), 4
# (128x128 at 64 planes, 256x256 forward) and 8 (256x256 backward, and 257x257
# with a scalar fill); at 512x512 the slices exceed 64 KB and keep a tail in
# device memory.
IN_SHAPES = [(2, 64, 32, 32), (1, 256, 16, 16), (2, 8, 31, 31), (3, 5, 1, 7), (1, 128, 8, 8),
             (1, 512, 2, 2), (1, 64, 256, 256), (1, 128, 128, 128), (1, 64, 128, 128),
             (1, 4, 257, 257), (1, 2, 512, 512)]


@pytest.mark.parametrize("slope", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("shape", IN_SHAPES)
def test_kernels_match_plain_version(cuda, shape, slope):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    before = launches("in.fwd", "in.bwd")
    y, mean, rstd = tin.in_act_fwd(x, 1e-5, slope)
    dx = tin.in_act_bwd(g, x, mean, rstd, slope)
    assert launches("in.fwd", "in.bwd") == (before[0] + 1, before[1] + 1)
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, 1e-5, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean, rstd, slope)
    torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, mean_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(dx, dx_r, rtol=0, atol=1e-4 * float(dx_r.abs().max()))


@pytest.mark.parametrize("shape", [(1, 64, 256, 256), (1, 4, 257, 257)])
def test_both_directions_repeat_bit_for_bit_on_a_cluster(cuda, shape):
    assert tin.plan(shape[0] * shape[1], shape[2] * shape[3], "fwd").group > 1
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, device=cuda, generator=gen) + 3.0
    g = torch.randn(shape, device=cuda, generator=gen)
    first = tin.in_act_fwd(x, 1e-5, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(first, tin.in_act_fwd(x, 1e-5, 0.2)))
    dx = tin.in_act_bwd(g, x, first[1], first[2], 0.2)
    assert torch.equal(dx, tin.in_act_bwd(g, x, first[1], first[2], 0.2))
    w, bias = torch.randn(shape[:2], device=cuda), torch.randn(shape[:2], device=cuda)
    fa = ta.adain_fwd(x, w, bias, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(fa, ta.adain_fwd(x, w, bias, 1e-5)))
    ba = ta.adain_bwd(g, x, w, fa[1], fa[2])
    assert all(torch.equal(a, b) for a, b in zip(ba, ta.adain_bwd(g, x, w, fa[1], fa[2])))


def test_a_refused_launch_raises_with_its_plan(cuda, monkeypatch):
    x = torch.randn(1, 2, 256, 256, device=cuda)
    # One CTA holding a whole 256 KB plane: over the 64 KB of shared memory
    # the kernels are allowed, so the card refuses the launch.
    big = tin.Plan("B", 1, 65536, 65536, 512, 2, 4 * 65536)
    monkeypatch.setattr(tin, "_plan_arg",
                        lambda planes, hw, direction, elem=4: (big, tin._c_plan(big, planes, hw)))
    before = tracing.counts["in.fwd"]
    with pytest.raises(RuntimeError, match="CUDA error .* Plan"):
        tin.in_act_fwd(x, 1e-5, 0.0)
    assert tracing.counts["in.fwd"] == before
    monkeypatch.undo()
    y, _, _ = tin.in_act_fwd(x, 1e-5, 0.0)  # the error did not stick
    torch.testing.assert_close(y, tin.in_act_fwd_ref(x, 1e-5, 0.0)[0], rtol=0, atol=1e-5)


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for mod, names in ((tin, ("in_act_fwd_ref", "in_act_bwd_ref")),
                       (ta, ("adain_fwd_ref", "adain_bwd_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    x = torch.randn(2, 3, 20, 20, device=cuda, requires_grad=True)
    w = torch.randn(2, 3, device=cuda, requires_grad=True)
    (tin.instance_norm_act(x, 0.2).sum() + ta.adain(x, w, w, 1e-5).sum()).backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(2, 4, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        tin.in_act_fwd(x.double(), 1e-5, 0.0)
    with pytest.raises(ValueError):
        tin.in_act_fwd(x.transpose(2, 3), 1e-5, 0.0)


def test_one_step_launches_every_site_through_the_kernels(cuda):
    import numpy as np

    from tpugan_torch.models import cyclegan

    cfg = cyclegan.Config(img_height=32, img_width=32, n_residual_blocks=9)
    modules = cyclegan.build(cfg, cuda)
    state = cyclegan.create_state(cfg, modules, cuda)
    step = cyclegan.make_step(cfg, modules, cuda)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)) for _ in "ab")
    tracing.reset()
    state, out = step(state, a, b)
    torch.cuda.synchronize()
    assert launches("in.fwd", "in.bwd") == (104, 104)
    assert all(torch.isfinite(v) for v in out.values())


def _gp_inputs(shape, device, seed=0):
    b, n0, n1, n2 = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*dims, fan_in=1):
        return (torch.rand(dims, device=device, generator=gen) * 2 - 1) / fan_in ** 0.5

    return (u(b, n0), u(n1, n0, fan_in=n0), u(n1, fan_in=n0), u(n2, n1, fan_in=n1),
            u(n2, fan_in=n1), u(1, n2, fan_in=n2))


@pytest.mark.parametrize("shape", [(64, 784, 512, 256), (1, 784, 512, 256), (7, 13, 100, 36),
                                   (65, 784, 512, 256), (256, 784, 512, 256)])
def test_gp_kernels_match_plain_version(cuda, shape):
    ins = _gp_inputs(shape, cuda)
    before = launches("gp.fwd", "gp.bwd")
    got = gp.mlp_gp_fwd(*ins)
    want = gp.mlp_gp_fwd_ref(*ins)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])  # masks
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    g, m1, m2, u, t = want
    q = gp.q_from(g, gp.norm_penalty(g)[1], 1.0).contiguous()
    res = (q, m1, m2, ins[1], ins[3], u, t)
    for a, b in zip(gp.mlp_gp_bwd(*res), gp.mlp_gp_bwd_ref(*res)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
    assert launches("gp.fwd", "gp.bwd") == (before[0] + 1, before[1] + 1)


def test_gp_kernels_reject_what_they_do_not_take(cuda):
    x, w1, b1, w2, b2, w3 = _gp_inputs((4, 16, 8, 8), cuda)
    with pytest.raises(TypeError):
        gp.mlp_gp_fwd(x.double(), w1, b1, w2, b2, w3)
    with pytest.raises(ValueError):
        gp.mlp_gp_fwd(x, w1.t().contiguous().t(), b1, w2, b2, w3)  # same values, strided
    g, m1, m2, u, t = gp.mlp_gp_fwd(x, w1, b1, w2, b2, w3)
    with pytest.raises(TypeError):
        gp.mlp_gp_bwd(g.double(), m1, m2, w1, w2, u, t)
    with pytest.raises(ValueError):
        gp.mlp_gp_bwd(g, m1.t(), m2, w1, w2, u, t)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_a_refused_gp_launch_raises_with_its_plan(cuda, monkeypatch, direction):
    shape = (64, 784, 512, 256)
    ins = _gp_inputs(shape, cuda)
    g, m1, m2, u, t = gp.mlp_gp_fwd_ref(*ins)
    res = (g, m1, m2, ins[1], ins[3], u, t)
    # A cluster of 16 CTAs: past the portable 8 that the kernels take, so
    # the C entry refuses the plan and launches nothing.
    good = gp.plan(*shape, direction)
    bad = good._replace(products=(good.products[0]._replace(ks=16),) + good.products[1:])
    monkeypatch.setattr(gp, "_plan_arg", lambda *key: (bad, None, gp.ctypes.byref(gp._c_plan(bad))))
    before = launches("gp.fwd", "gp.bwd")
    with pytest.raises(RuntimeError, match="CUDA error .* Plan"):
        gp.mlp_gp_fwd(*ins) if direction == "fwd" else gp.mlp_gp_bwd(*res)
    assert launches("gp.fwd", "gp.bwd") == before
    monkeypatch.undo()
    got = gp.mlp_gp_fwd(*ins) if direction == "fwd" else gp.mlp_gp_bwd(*res)  # no error stuck
    want = gp.mlp_gp_fwd_ref(*ins) if direction == "fwd" else gp.mlp_gp_bwd_ref(*res)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4 * float(want[0].abs().max()))


@pytest.mark.parametrize("shape", [(64, 784, 512, 256), (65, 784, 512, 256), (7, 13, 100, 36)])
def test_gp_kernels_repeat_bit_for_bit(cuda, shape):
    """Split-K over clusters adds the partial tiles in rank order: no
    atomics, so both directions give the same bits every run."""
    ins = _gp_inputs(shape, cuda, seed=2)
    first = gp.mlp_gp_fwd(*ins)
    assert all(torch.equal(a, b) for a, b in zip(first, gp.mlp_gp_fwd(*ins)))
    g, m1, m2, u, t = first
    q = gp.q_from(g, gp.norm_penalty(g)[1], 1.0).contiguous()
    res = (q, m1, m2, ins[1], ins[3], u, t)
    d = gp.mlp_gp_bwd(*res)
    assert all(torch.equal(a, b) for a, b in zip(d, gp.mlp_gp_bwd(*res)))


def test_one_wgan_gp_d_step_launches_the_gp_pair_once(cuda):
    import numpy as np

    from tpugan_torch.models import wgan_gp

    cfg = wgan_gp.Config()
    modules = wgan_gp.build(cfg, cuda)
    state = wgan_gp.create_state(cfg, modules, cuda)
    d_step, _ = wgan_gp.make_steps(cfg, state)
    imgs = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (64, 28, 28, 1), dtype=np.uint8))
    tracing.reset()
    state, out = d_step(state, imgs)
    torch.cuda.synchronize()
    assert launches("gp.fwd", "gp.bwd") == (1, 1)
    assert torch.isfinite(out["d_loss"])


def _adain_inputs(shape, device, seed=0):
    b, c = shape[:2]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=gen)
    g = torch.randn(shape, device=device, generator=gen)
    w = 1.0 + 0.3 * torch.randn((b, c), device=device, generator=gen)
    w[:, ::3] = 0.0  # zeros and negatives
    w[:, 1::3] *= -1.0
    bias = 0.3 * torch.randn((b, c), device=device, generator=gen)
    return x, w, bias, g


@pytest.mark.parametrize("shape", [(1, 256, 32, 32), (40, 256, 32, 32), (2, 8, 31, 31),
                                   (2, 4, 1, 1), (1, 64, 128, 128), (1, 16, 256, 256)])
def test_adain_kernels_match_plain_version(cuda, shape):
    x, w, bias, g = _adain_inputs(shape, cuda)
    before = launches("adain.fwd", "adain.bwd")
    y, mean, rstd = ta.adain_fwd(x, w, bias, 1e-5)
    grads = ta.adain_bwd(g, x, w, mean, rstd)
    assert launches("adain.fwd", "adain.bwd") == (before[0] + 1, before[1] + 1)
    y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w, bias, 1e-5)
    torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())))
    torch.testing.assert_close(mean, mean_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    for a, b in zip(grads, ta.adain_bwd_ref(g, x, w, mean, rstd)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)


def _refused_adain_call(case, x, w, bias, g, mean, rstd):
    """One call the AdaIN wrappers refuse, and the error it raises."""
    column = torch.randn(w.shape[::-1], device=w.device).t()  # (B, C), column stride B
    return {
        "float64 map": (TypeError, lambda: ta.adain_fwd(x.double(), w, bias, 1e-5)),
        "transposed map": (ValueError, lambda: ta.adain_fwd(x.transpose(2, 3), w, bias, 1e-5)),
        "column-strided w": (ValueError, lambda: ta.adain_fwd(x, column, bias, 1e-5)),
        "column-strided bias": (ValueError, lambda: ta.adain_fwd(x, w, column, 1e-5)),
        "bf16 map, float32 w": (TypeError, lambda: ta.adain_fwd(x.bfloat16(), w, bias.bfloat16(),
                                                               1e-5)),
        "float32 map, bf16 w": (TypeError, lambda: ta.adain_fwd(x, w.bfloat16(), bias, 1e-5)),
        "float64 gradient": (TypeError, lambda: ta.adain_bwd(g.double(), x, w, mean, rstd)),
        "backward, column-strided w": (ValueError, lambda: ta.adain_bwd(g, x, column, mean, rstd)),
        "backward, bf16 map, float32 w": (TypeError, lambda: ta.adain_bwd(
            g.bfloat16(), x.bfloat16(), w, mean, rstd)),
        "backward, float32 map, bf16 w": (TypeError, lambda: ta.adain_bwd(
            g, x, w.bfloat16(), mean, rstd)),
    }[case]


REFUSED_ADAIN = ["float64 map", "transposed map", "column-strided w", "column-strided bias",
                 "bf16 map, float32 w", "float32 map, bf16 w", "float64 gradient",
                 "backward, column-strided w", "backward, bf16 map, float32 w",
                 "backward, float32 map, bf16 w"]


@pytest.mark.parametrize("case", REFUSED_ADAIN)
def test_adain_kernels_reject_what_they_do_not_take(cuda, case):
    """A map of another dtype or layout, w or bias whose entries of a row are
    not adjacent, and a mixed bf16/float32 call raise and launch nothing;
    nothing converts or copies to reach a kernel. A row-strided w or bias is
    taken (``test_adain_kernels_take_row_strided_slices``)."""
    x, w, bias, g = _adain_inputs((2, 4, 8, 8), cuda)
    _, mean, rstd = ta.adain_fwd(x, w, bias, 1e-5)
    error, call = _refused_adain_call(case, x, w, bias, g, mean, rstd)
    counts = lambda: launches("adain.fwd", "adain.bwd", "adain.fwd.bf16", "adain.bwd.bf16")
    before = counts()
    with pytest.raises(error):
        call()
    assert counts() == before


def _assert_adain_close(got, want, atol):
    """Within ``atol``, plus one bf16 ulp where ``got`` is bf16."""
    if got.dtype is torch.bfloat16:
        _assert_within_bf16(got, want, atol)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 256, 32, 32), (40, 256, 32, 32), (2, 8, 31, 31),
                                   (1, 64, 128, 128)])
def test_adain_kernels_take_row_strided_slices(cuda, shape, dtype):
    """w and bias as column slices of a (B, 4C) tensor, rows 4C apart, as the
    AdaIN residual block takes them: read in place, the bits of the same
    calls on contiguous copies, and the plain version's values; dw and dbias
    contiguous (B, C) in w's dtype. Through ``adain()``, the (B, 4C)
    gradient is the plain version's dw and dbias in their columns."""
    x, _, _, g = (t.to(dtype) for t in _adain_inputs(shape, cuda))
    b, c = shape[:2]
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = (0.5 + 0.5 * torch.randn((b, 4 * c), device=cuda, generator=gen)).to(dtype)
    w_s, b_s = params[:, c:2 * c], params[:, :c]
    w_c, b_c = w_s.contiguous(), b_s.contiguous()
    fwd = ta.adain_fwd(x, w_s, b_s, 1e-5)
    bwd = ta.adain_bwd(g, x, w_s, fwd[1], fwd[2])
    assert all(torch.equal(u, v) for u, v in zip((*fwd, *bwd), (
        *ta.adain_fwd(x, w_c, b_c, 1e-5), *ta.adain_bwd(g, x, w_c, fwd[1], fwd[2]))))
    assert [(t.dtype, t.shape, t.is_contiguous()) for t in bwd[1:]] == [(dtype, (b, c), True)] * 2
    y_r, _, _ = ta.adain_fwd_ref(x, w_c, b_c, 1e-5)
    dx_r, dw_r, db_r = ta.adain_bwd_ref(g, x, w_c, fwd[1], fwd[2])
    _assert_adain_close(fwd[0], y_r, 1e-5 * max(1.0, float(w_c.float().abs().max())))
    for got, want in zip(bwd, (dx_r, dw_r, db_r)):
        _assert_adain_close(got, want, 1e-4 * float(want.float().abs().max()) + 1e-7)
    params.requires_grad_()
    y = ta.adain(x, params[:, c:2 * c], params[:, :c], 1e-5)
    (dp,) = torch.autograd.grad(y, params, g)
    assert torch.equal(y, fwd[0])
    assert torch.equal(dp[:, :c], bwd[2]) and torch.equal(dp[:, c:2 * c], bwd[1])
    assert not dp[:, 2 * c:].any()


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_call_is_one_kernel(cuda, dtype, layout):
    """One ``adain_fwd`` and one ``adain_bwd`` call launch exactly one device
    kernel each, the affine instance of ``instance_norm.cu``'s pair
    (torch.profiler, ``chip_smoke.one_affine_kernel_a_call``), in float32
    and bf16, on contiguous and on strided w/bias at the MUNIT step shape;
    dw and dbias come back in w's dtype."""
    from chip_smoke import call_kernels, one_affine_kernel_a_call

    shape = (1, 256, 32, 32)
    x, w, bias, g = (t.to(dtype) for t in _adain_inputs(shape, cuda))
    if layout == "strided":
        params = torch.cat([bias, w, bias, w], dim=1)
        w, bias = params[:, 256:512], params[:, :256]
        assert w.stride(0) == 1024
    _, mean, rstd = ta.adain_fwd(x, w, bias, 1e-5)
    for k, fn in (("fwd", lambda: ta.adain_fwd(x, w, bias, 1e-5)),
                  ("bwd", lambda: ta.adain_bwd(g, x, w, mean, rstd))):
        names = call_kernels(fn, 10, 10)
        assert one_affine_kernel_a_call(names, 10, k), names
    assert {t.dtype for t in ta.adain_bwd(g, x, w, mean, rstd)} == {dtype}


def test_one_munit_step_launches_every_site_through_the_kernels(cuda):
    import numpy as np

    from tpugan_torch.models import munit

    cfg = munit.Config(img_height=64, img_width=64)
    modules = munit.build(cfg, cuda)
    state = munit.create_state(cfg, modules, cuda)
    step = munit.make_step(cfg, modules, cuda)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)) for _ in "ab")
    tracing.reset()
    state, out = step(state, a, b)
    torch.cuda.synchronize()
    assert launches("adain.fwd", "adain.bwd") == (24, 24)
    assert launches("in.fwd", "in.bwd") == (90, 90)
    assert all(torch.isfinite(v) for v in out.values())


def test_dcgan_step_on_the_card_matches_the_cpu(cuda):
    """The headline step (64px, batch 64, latent 100) from the same weights,
    batch, z and Dropout2d masks on both devices; it launches none of the
    port's kernels. Gradient floors per module, from the measured card-CPU
    differences on an H100: cuDNN's FFT and Winograd convolutions put G's
    up to 6e-4 of its largest gradient apart, D's stay below 3e-6 of its
    largest. Every card parameter is Adam's first step of its own card
    gradient, and agrees with the CPU's where the gradient is above the
    floor."""
    import numpy as np

    from tpugan_torch.models import dcgan

    cfg = dcgan.Config(img_size=64, synthetic_data=True)
    b = cfg.batch_size
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, 64, 64, 1), dtype=np.uint8))
    draws = torch.Generator().manual_seed(1)
    z = torch.randn(b, cfg.latent_dim, generator=draws)
    masks = [dcgan.build(cfg, "cpu")["discriminator"].draw_masks(b, draws) for _ in range(3)]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    runs = {}
    try:
        for dev in (torch.device("cpu"), cuda):
            modules = dcgan.build(cfg, dev)
            p0 = {r: {k: p.detach().cpu().clone() for k, p in m.named_parameters()}
                  for r, m in modules.items()}
            state = dcgan.create_state(cfg, modules, dev)
            state, out = dcgan.make_step(cfg, state)(
                state, imgs.to(dev), None, z=z.to(dev),
                masks=[[m.to(dev) for m in ms] for ms in masks])
            runs[dev.type] = (modules, p0, {k: v.cpu() for k, v in out.items()})
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert counts == launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    (mods_c, p0_c, out_c), (mods_g, p0_g, out_g) = runs["cpu"], runs["cuda"]
    for k in ("d_loss", "g_loss"):
        torch.testing.assert_close(out_g[k], out_c[k], rtol=1e-4, atol=0)
    torch.testing.assert_close(out_g["gen_imgs"], out_c["gen_imgs"], rtol=0, atol=1e-4)
    for role, rel_floor in (("generator", 1e-3), ("discriminator", 1e-5)):
        params_c = dict(mods_c[role].named_parameters())
        largest = max(float(p.grad.abs().max()) for p in params_c.values())
        floor = rel_floor * largest
        worst = max(float((p.grad.cpu() - params_c[k].grad).abs().max())
                    for k, p in mods_g[role].named_parameters())
        print(f"{role}: card-CPU gradients differ by at most {worst / largest:.3e} of the "
              f"largest gradient ({largest:.3e}); floor {rel_floor:.0e} of it")
        for k, p in mods_g[role].named_parameters():
            want, grad = params_c[k], p.grad.cpu()
            torch.testing.assert_close(p0_g[role][k], p0_c[role][k], rtol=0, atol=0)
            torch.testing.assert_close(grad, want.grad, rtol=1e-3, atol=floor, msg=lambda m: (
                f"{role} {k}: |g| max {float(want.grad.abs().max()):.3e}, card-CPU "
                f"{float((grad - want.grad).abs().max()):.3e}, floor {floor:.3e}\n{m}"))
            torch.testing.assert_close(p.detach().cpu(), _adam_first_step(p0_g[role][k], grad, cfg),
                                       rtol=1e-6, atol=1e-7, msg=lambda m: f"{role} {k}: {m}")
            diff = (p.detach().cpu() - want.detach()).abs()
            settled = want.grad.abs() > max(floor, 1e-6)
            if settled.any():
                assert float(diff[settled].max()) <= 1e-5, (role, k, float(diff[settled].max()))
        stats_c = mods_c[role].state_dict()
        for k, v in mods_g[role].state_dict().items():
            if "running" in k:
                torch.testing.assert_close(v.cpu(), stats_c[k], rtol=1e-4, atol=1e-5)


def _adam_first_step(p0, g, cfg, eps=1e-8, weight_decay=0.0):
    """torch.optim.Adam's first update from ``p0`` with gradient ``g``: the
    bias-corrected moments are g and g**2, so the step is lr * g / (|g| + eps),
    ``weight_decay * p0`` first added to g."""
    g = g.double() + weight_decay * p0.double()
    return (p0.double() - cfg.lr * g / (g.abs() + eps)).float()

# --- Fused dispatch: K steps captured in one CUDA graph and replayed ---------
#
# Replay against eager: the same state from the same seed, the same batches
# and draws, run (a) as eager steps several times and (b) through
# ``graph_steps``: a first call (the eager warm-up), a second (the capture
# and its replay), a third (batches copied in, a replay), then one eager
# step after the replays. Where the eager runs agree bit for bit on a
# tensor, the replay must too. Where they do not (cuDNN's weight gradients
# at 64px use atomics, and Adam turns their rounding into steps of up to
# lr), the replay is one more run of the same nondeterministic arithmetic,
# held by ``chip_smoke.replay_rule``: by module, its distance to the nearest
# of ``REPLAY_EAGER`` eager runs within the mean plus ``REPLAY_K`` standard
# deviations of the eager-eager distances, which a sound replay passes but
# for at most 1 / 2501 a module (Cantelli's inequality).


def _snapshot(state) -> dict:
    snap = {"draws": state.draws.get_state(), "step": torch.tensor(state.step)}
    for role, m in state.modules.items():
        for k, v in m.state_dict().items():
            snap[f"{role}.{k}"] = v.detach().cpu().clone()
        for i, st in enumerate(state.optimizers[role].state.values()):
            for k, v in st.items():
                snap[f"{role}.opt{i}.{k}"] = torch.as_tensor(v).detach().cpu().clone()
    for k, v in state.aux.items():  # began's k
        snap[f"aux.{k}"] = v.detach().cpu().clone()
    return snap


def _fused_against_eager(make, k, batches, n_eager=None):
    """``make() -> (state, step)``; ``batches`` (3, k, ...) uint8 on the
    card. Returns the ``n_eager`` eager snapshots, the replayed one, and the
    ``GraphSteps``."""
    from chip_smoke import REPLAY_EAGER
    from tpugan_torch.train.loop import graph_steps

    snaps = []
    for _ in range(n_eager or REPLAY_EAGER):
        state, step = make()
        for chunk in batches:
            for b in chunk:
                state, _ = step(state, b)
        state, _ = step(state, batches[0][0])
        torch.cuda.synchronize()
        snaps.append(_snapshot(state))
    state, step = make()
    replays = tracing.counts["graph.replays"]
    fused = graph_steps(step, k)
    for chunk in batches:
        state, out = fused(state, chunk)
    state, _ = step(state, batches[0][0])
    torch.cuda.synchronize()
    assert (fused.calls, fused.replays) == (3, 2) and fused.graph is not None
    assert tracing.counts["graph.replays"] - replays == 2
    assert all(bool(torch.isfinite(out[n]).all()) for n in out)
    return snaps, _snapshot(state), fused


def _assert_replay_matches_eager(eager, replay):
    """``chip_smoke.replay_rule``: the generator state, the step and every
    tensor the eager runs agree on bit for bit equal; by module, the
    replay's distance to the nearest eager run within the rule's threshold.
    Returns {module: (replay-nearest eager, largest eager-eager,
    threshold)}."""
    from chip_smoke import replay_rule

    worst, _ = replay_rule(eager, replay)
    print("by module (replay-nearest eager, largest eager-eager, threshold):", worst)
    return worst


def test_replayed_dcgan_steps_match_eager_steps(cuda):
    import numpy as np

    from tpugan_torch.models import dcgan

    k = 3
    cfg = dcgan.Config(img_size=64, synthetic_data=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def make():
        state = dcgan.create_state(cfg, dcgan.build(cfg, cuda), cuda)
        return state, dcgan.make_step(cfg, state)

    batches = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, k, cfg.batch_size, 64, 64, 1), dtype=np.uint8)).to(cuda)
    eager, replay, fused = _fused_against_eager(make, k, batches)
    _assert_replay_matches_eager(eager, replay)
    print(f"capture {fused.capture_s:.3f} s, instantiate {fused.instantiate_s:.3f} s, "
          f"max_memory_allocated {fused.memory_before} -> {fused.memory_after} B")


def test_replayed_dcgan_steps_equal_eager_steps_with_deterministic_cudnn(cuda, monkeypatch):
    """With cuDNN held to deterministic algorithms, the two eager runs agree
    bit for bit, and so must the replay, on every tensor."""
    import numpy as np

    from tpugan_torch.models import dcgan

    k = 3
    cfg = dcgan.Config(img_size=64, synthetic_data=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def make():
        state = dcgan.create_state(cfg, dcgan.build(cfg, cuda), cuda)
        return state, dcgan.make_step(cfg, state)

    batches = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, k, cfg.batch_size, 64, 64, 1), dtype=np.uint8)).to(cuda)
    (a, b), replay, _ = _fused_against_eager(make, k, batches, n_eager=2)
    for name in a:
        assert torch.equal(b[name], a[name]), f"{name}: the eager runs differ"
        assert torch.equal(replay[name], a[name]), f"{name}: the replay differs"


def test_replayed_wgan_gp_units_match_eager_units(cuda):
    import numpy as np

    from tpugan_torch.models import wgan_gp
    from tpugan_torch.models._critic_family import make_schedule_unit

    k = 2
    cfg = wgan_gp.Config(synthetic_data=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    def make():
        state = wgan_gp.create_state(cfg, wgan_gp.build(cfg, cuda), cuda)
        d_step, g_step = wgan_gp.make_steps(cfg, state)
        unit = make_schedule_unit(cfg, d_step, g_step)
        return state, unit

    batches = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, k, cfg.n_critic, cfg.batch_size, 28, 28, 1), dtype=np.uint8)).to(cuda)
    tracing.reset()
    eager, replay, fused = _fused_against_eager(make, k, batches)
    _assert_replay_matches_eager(eager, replay)
    # Eager: 4 runs of 3 chunks and one unit; fused: the warm-up chunk, the
    # captured chunk and one unit. Each unit is n_critic critic steps.
    per_chunk = k * cfg.n_critic
    runs = len(eager)
    assert tracing.counts["gp.fwd.captured"] == tracing.counts["gp.bwd.captured"] == per_chunk
    assert (tracing.counts["gp.fwd"] == tracing.counts["gp.bwd"]
            == (runs * 3 + 2) * per_chunk + (runs + 1) * cfg.n_critic)


def test_a_replayed_unit_launches_the_gp_kernels_once_each_way_per_critic_step(cuda):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from tpugan_torch.models import wgan_gp
    from tpugan_torch.models._critic_family import make_schedule_unit
    from tpugan_torch.train.loop import graph_steps

    k = 2
    cfg = wgan_gp.Config(synthetic_data=True)
    state = wgan_gp.create_state(cfg, wgan_gp.build(cfg, cuda), cuda)
    fused = graph_steps(make_schedule_unit(cfg, *wgan_gp.make_steps(cfg, state)), k)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (k, cfg.n_critic, cfg.batch_size, 28, 28, 1), dtype=np.uint8)).to(cuda)
    for _ in range(2):
        state, _ = fused(state, imgs)
    torch.cuda.synchronize()
    tracing.reset()
    for _ in range(3):  # the profiler drops every event in some runs
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, out = fused(state, imgs)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    # Four forward products and two backward launches per critic step, and
    # no wrapper call on the host: the graph launched them.
    assert sum("gp_gemm<" in n for n in names) == 6 * k * cfg.n_critic, sorted(set(names))
    assert launches("gp.fwd", "gp.bwd") == (0, 0)
    assert bool(torch.isfinite(out["d_loss"]).all())


@pytest.mark.parametrize("name", ["dcgan", "wgan_gp", "wgan", "gan", "wgan_div", "dragan", "cgan",
                                  "acgan", "sgan", "infogan", "context_encoder", "ccgan"])
def test_fused_main_writes_the_rows_and_samples_of_the_unfused_main(cuda, tmp_path, name):
    """The trainer's ``main`` on the card with ``--steps_per_dispatch 3``
    (the loader's thread copying while the graph is captured) against the
    same ``main`` unfused: the same metric rows and PNG names, finite."""
    import importlib
    import json
    import os

    mod = importlib.import_module(f"tpugan_torch.models.{name}")
    argv = ["--synthetic_data", "--n_epochs", "2", "--max_batches", "20", "--sample_interval",
            "4", "--log_interval", "0"]
    if name in ("wgan_gp", "wgan", "wgan_div"):
        argv += ["--n_critic", "2"]
    if name == "dragan":  # its grid is the last logged batch's, each epoch
        argv[argv.index("--log_interval") + 1] = "5"
    rows, pngs = {}, {}
    for k in (1, 3):
        out = tmp_path / str(k)
        mod.main(argv + ["--steps_per_dispatch", str(k), "--output_dir", str(out),
                         "--metrics_jsonl", str(out / "m.jsonl")])
        torch.cuda.synchronize()
        rows[k] = [json.loads(line) for line in (out / "m.jsonl").read_text().splitlines()]
        pngs[k] = sorted(os.path.relpath(os.path.join(r, f), out)
                         for r, _, files in os.walk(out / "images") for f in files)
    assert [(r["step"], sorted(r)) for r in rows[3]] == [(r["step"], sorted(r)) for r in rows[1]]
    assert pngs[3] == pngs[1] and pngs[1]
    assert all(all(torch.isfinite(torch.tensor(v)) for v in r.values()) for r in rows[3])


# --- The rest of the critic family and the conditional family: one step ------
#
# Each trainer at its reference configuration, from the same weights (drawn
# on the CPU), batch and draws (drawn on the CPU and moved) on both devices.
# The gradients each optimizer applies are recorded by wrapping its ``step``.

STEP_TRAINERS = ["gan", "wgan_div", "dragan", "cgan", "acgan", "sgan", "infogan"]
# The gradient floor of each optimizer, a share of its module's largest
# CPU gradient: 1e-3 where cuDNN's convolutions put gradients that reach the
# generator through the discriminator apart (as DCGAN's), 1e-5 for the
# discriminators (cuDNN and cuBLAS). Measured card-CPU differences on an
# H100: the generators up to 3.9e-4 of their largest (infogan), but acgan's
# 1.8e-3, where the cross-entropy of the aux head sends gradients of about
# 1e-5 through the discriminator's convolutions; the discriminators up to
# 5.2e-6 (acgan); infogan's information phase 2.1e-3 of its generator's
# largest, since it starts from parameters that Adam's first G and D steps
# already moved apart by up to lr where their gradients were rounding noise.
STEP_FLOORS = {"generator": 1e-3, "discriminator": 1e-5, "info": 1e-3}
STEP_FLOOR_OVERRIDES = {("acgan", "generator"): 5e-3, ("infogan", "info"): 5e-3}


def _record_updates(state):
    names = {id(p): (role, k) for role, m in state.modules.items()
             for k, p in m.named_parameters()}
    rec = {}
    for name, opt in state.optimizers.items():
        params = [p for g in opt.param_groups for p in g["params"]]

        def step(*a, _name=name, _params=params, _orig=opt.step, **kw):
            before = [(p.detach().cpu().clone(), None if p.grad is None else p.grad.cpu())
                      for p in _params]
            result = _orig(*a, **kw)
            rec[_name] = {names[id(p)]: (b, g, p.detach().cpu().clone())
                          for (b, g), p in zip(before, _params)}
            return result

        opt.step = step
    return rec


def _step_draws(name, cfg, D, shape, g):
    """The step's keyword draws, on the CPU, in the step's own order."""
    b = shape[0]
    kw = {"z": torch.randn(b, cfg.latent_dim, generator=g)}
    if name in ("cgan", "acgan", "infogan"):
        kw["gen_labels"] = torch.randint(0, cfg.n_classes, (b,), generator=g)
    if name == "infogan":
        kw["code"] = torch.rand(b, cfg.code_dim, generator=g) * 2 - 1
        kw["info_z"] = torch.randn(b, cfg.latent_dim, generator=g)
        kw["info_labels"] = torch.randint(0, cfg.n_classes, (b,), generator=g)
        kw["info_code"] = torch.rand(b, cfg.code_dim, generator=g) * 2 - 1
    if hasattr(D, "draw_masks"):
        kw["masks"] = [D.draw_masks(b, g) for _ in range(4 if name in ("dragan", "infogan") else 3)]
    if name == "dragan":
        kw["alpha"] = torch.rand(shape, generator=g)
        kw["noise"] = torch.rand(shape, generator=g)
    return kw


def _to(kw, dev):
    return {k: [[m.to(dev) for m in ms] for ms in v] if k == "masks" else v.to(dev)
            for k, v in kw.items()}


@pytest.mark.parametrize("name", STEP_TRAINERS)
def test_one_step_on_the_card_matches_the_cpu(cuda, name):
    """Losses, images, every optimizer's gradients, Adam's first step of the
    card's own gradients, parameters where settled and running statistics,
    card against CPU; no kernel of the port launched."""
    import importlib

    import numpy as np

    mod = importlib.import_module(f"tpugan_torch.models.{name}")
    cfg = mod.Config(synthetic_data=True)
    b, size = cfg.batch_size, cfg.img_size
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, size, size, 1), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, b).astype(np.int32))
    kw = _step_draws(name, cfg, mod.build(cfg, "cpu")["discriminator"], (b, 1, size, size),
                     torch.Generator().manual_seed(1))
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    runs = []
    try:
        for dev in (torch.device("cpu"), cuda):
            modules = mod.build(cfg, dev)
            state = mod.create_state(cfg, modules, dev)
            rec = _record_updates(state)
            if name == "wgan_div":
                d_step, g_step = mod.make_steps(cfg, state)
                state, d_out = d_step(state, imgs.to(dev), None, **_to(kw, dev))
                state, out = g_step(state, d_out["z"])
                out = {**d_out, **out}
            else:
                state, out = mod.make_step(cfg, state)(state, imgs.to(dev), labels.to(dev),
                                                       **_to(kw, dev))
            runs.append((modules, rec, {k: v.cpu() for k, v in out.items()}))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert counts == launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    (mods_c, rec_c, out_c), (mods_g, rec_g, out_g) = runs
    for k in ("d_loss", "g_loss", "info_loss", "d_acc"):
        if k in out_c:
            torch.testing.assert_close(out_g[k], out_c[k], rtol=1e-4, atol=0, msg=k)
    torch.testing.assert_close(out_g["gen_imgs"], out_c["gen_imgs"], rtol=0, atol=1e-4)
    settled, seen = {}, set()
    for opt_name, want in rec_c.items():
        got = rec_g[opt_name]
        largest = {}
        for (role, _), (_, grad, _) in want.items():
            if grad is not None:
                largest[role] = max(largest.get(role, 0.0), float(grad.abs().max()))
        worst = {}
        share = STEP_FLOOR_OVERRIDES.get((name, opt_name), STEP_FLOORS[opt_name])
        for key, (before_c, grad_c, _) in want.items():
            before_g, grad_g, after_g = got[key]
            if key not in seen:  # a later optimizer starts from the earlier's update
                torch.testing.assert_close(before_g, before_c, rtol=0, atol=0)
                seen.add(key)
            if grad_c is None:
                assert grad_g is None, (opt_name, key)
                continue
            role = key[0]
            floor = share * largest[role]
            worst[role] = max(worst.get(role, 0.0), float((grad_g - grad_c).abs().max()))
            torch.testing.assert_close(grad_g, grad_c, rtol=1e-3, atol=floor, msg=lambda m: (
                f"{opt_name} {key}: |g| max {float(grad_c.abs().max()):.3e}, card-CPU "
                f"{float((grad_g - grad_c).abs().max()):.3e}, floor {floor:.3e}\n{m}"))
            torch.testing.assert_close(after_g, _adam_first_step(before_g, grad_g, cfg),
                                       rtol=1e-6, atol=1e-7, msg=lambda m: f"{key}: {m}")
            mask = grad_c.abs() > max(floor, 1e-6)
            settled[key] = settled.get(key, True) & mask
        print(f"{name} {opt_name}: card-CPU gradients differ by at most " + ", ".join(
            f"{role} {worst[role] / largest[role]:.3e}" for role in worst)
            + f" of the largest; floor {share:.0e}")
    for role, m in mods_g.items():
        cpu = dict(mods_c[role].named_parameters())
        for k, p in m.named_parameters():
            mask = settled.get((role, k))
            if mask is not None and mask.any():
                diff = (p.detach().cpu() - cpu[k].detach()).abs()[mask]
                assert float(diff.max()) <= 1e-5, (role, k, float(diff.max()))
        stats_c = mods_c[role].state_dict()
        for k, v in m.state_dict().items():
            if "running" in k or "num_batches" in k:
                torch.testing.assert_close(v.cpu(), stats_c[k], rtol=1e-4, atol=1e-5, msg=k)


# --- The im2im trainers: one step ----------------------------------------------
#
# pix2pix, discogan, dualgan (one d_step and one g_step), context_encoder and
# ccgan at their reference configurations, the same weights, batch and
# draws on both devices: the dropout masks drawn on the CPU run and passed to
# the card's, the mask corners and dualgan's alphas drawn beforehand. Losses
# 1e-4 relative; each optimizer's gradients 1e-3 relative plus
# ``IM2IM_FLOORS`` of its module's largest CPU gradient; Adam's first step of
# the card's own gradients; running statistics 1e-4 relative and
# ``IM2IM_STATS_ATOL`` absolute (dualgan's critics: after the d_step, before
# Adam's first step moves a weight by up to lr where its gradient is
# rounding); the card's IN launches, one a site, each way. The floors are
# wider than the MNIST trainers' because a ReLU or LeakyReLU unit whose
# pre-activation lies within rounding of 0 takes its other slope on one
# device (the CPU tests show one such unit moving a generator's gradient by
# up to 1e-3 of its largest), and the U-Nets' deep sums at batch 8-64 carry
# cuDNN's rounding further. Measured
# on an H100 (the test prints each share): pix2pix 4.8e-4 and 8.3e-4;
# discogan's generators 2.8e-3; dualgan 6.0e-4, its critics 6.2e-4;
# context_encoder 1.8e-4 and 1.8e-3; ccgan's generator 2.6e-3. The running
# statistics take 5e-5 absolute: dualgan's critic statistics after the
# d_step, whose fakes come out of a 7-down U-Net through cuDNN, lay up to
# 1.5e-5 apart.

IM2IM_FLOORS = {"generator": 5e-3, "discriminator": 5e-3, "G": 5e-3, "D_A": 5e-3, "D_B": 5e-3}
IM2IM_STATS_ATOL = 5e-5


def _draws_recorded(run):
    """``run()`` with every MaskedDropout mask drawn recorded, in call order."""
    from tpugan_torch.nn.layers import MaskedDropout

    seen, draw = [], MaskedDropout.draw_mask

    def record(self, shape, generator):
        m = draw(self, shape, generator)
        seen.append(m.cpu())
        return m

    MaskedDropout.draw_mask = record
    try:
        out = run()
    finally:
        MaskedDropout.draw_mask = draw
    return out, seen


def _im2im_step(name, mod, cfg, state, batch, draws):
    """One step (dualgan: d_step then g_step) with the given draws, or with
    the masks drawn and recorded when ``draws["masks"]`` is None. Returns
    (out, masks)."""
    masks = draws.get("masks")
    if name == "dualgan":
        d_step, g_step = mod.make_steps(cfg, state)

        def run():
            _, d_out = d_step(state, *batch, masks=None if masks is None else masks[:2],
                              alphas=draws["alphas"])
            for role in ("D_A", "D_B"):
                draws[f"{role} stats"] = {k: v.cpu().clone() for k, v in
                                          state.modules[role].state_dict().items()
                                          if "running" in k}
            _, g_out = g_step(state, *batch, masks=None if masks is None else masks[2:])
            return {**d_out, **g_out}

        groups = [7] * 6
    else:
        kw = {"corners": draws["corners"]} if "corners" in draws else {}
        step = mod.make_step(cfg, state)
        sites = {"pix2pix": [9], "discogan": [7] * 4, "ccgan": [7], "context_encoder": []}[name]
        flat = {"pix2pix": True, "ccgan": True}.get(name, False)

        def run():
            if sites:
                kw["masks"] = None if masks is None else (masks[0] if flat else masks)
            return step(state, *batch, **kw)[1]

        groups = sites
    if masks is not None:
        return run(), masks
    out, seen = _draws_recorded(run)
    it = iter(seen)
    return out, [[next(it) for _ in range(n)] for n in groups]


@pytest.mark.parametrize("name", ["pix2pix", "discogan", "dualgan", "context_encoder", "ccgan"])
def test_one_im2im_step_on_the_card_matches_the_cpu(cuda, name):
    import importlib

    import numpy as np

    mod = importlib.import_module(f"tpugan_torch.models.{name}")
    cfg = mod.Config(synthetic_data=True)
    size = getattr(cfg, "img_size", None) or cfg.img_height
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, size, size, 3),
                                          dtype=np.uint8)) for _ in range(2)]
    batch = imgs if name in ("pix2pix", "discogan", "dualgan") else imgs[:1]
    g = torch.Generator().manual_seed(1)
    draws = {"masks": None}
    if name == "dualgan":
        draws["alphas"] = [torch.rand(cfg.batch_size, 1, 1, 1, generator=g) for _ in range(2)]
    if name in ("context_encoder", "ccgan"):
        draws["corners"] = torch.randint(0, size - cfg.mask_size, (cfg.batch_size, 2), generator=g)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    try:
        for dev in (torch.device("cpu"), cuda):
            modules = mod.build(cfg, dev)
            state = mod.create_state(cfg, modules, dev)
            rec = _record_updates(state)
            moved = {k: v if k == "masks" and v is None else
                     [[m.to(dev) for m in ms] for ms in v] if k == "masks" else
                     [a.to(dev) for a in v] if k == "alphas" else v.to(dev)
                     for k, v in draws.items() if not k.endswith("stats")}
            tracing.reset()
            out, masks = _im2im_step(name, mod, cfg, state, [x.to(dev) for x in batch], moved)
            torch.cuda.synchronize()
            draws["masks"] = masks
            stats = {r: draws.pop(f"{r} stats") for r in ("D_A", "D_B") if f"{r} stats" in draws}
            runs.append((modules, rec, {k: v.cpu() for k, v in out.items() if v.ndim == 0},
                         launches("in.fwd", "in.bwd"), stats))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    (mods_c, rec_c, out_c, _, d_stats_c), (mods_g, rec_g, out_g, launched, d_stats_g) = runs
    import chip_smoke

    units = ("d_step", "g_step") if name == "dualgan" else ("step",)
    want = tuple(sum(chip_smoke.im2im_per_unit(name, u, d) for u in units) for d in ("fwd", "bwd"))
    assert launched == want, (launched, want)
    for k in out_c:
        torch.testing.assert_close(out_g[k], out_c[k], rtol=1e-4, atol=0, msg=k)
    for opt_name, want_rec in rec_c.items():
        got = rec_g[opt_name]
        largest = {}
        for (role, _), (_, grad, _) in want_rec.items():
            if grad is not None:
                largest[role] = max(largest.get(role, 0.0), float(grad.abs().max()))
        worst, share = {}, IM2IM_FLOORS[opt_name]
        for key, (before_c, grad_c, _) in want_rec.items():
            before_g, grad_g, after_g = got[key]
            if grad_c is None:
                assert grad_g is None, (opt_name, key)
                continue
            role = key[0]
            floor = share * largest[role]
            worst[role] = max(worst.get(role, 0.0), float((grad_g - grad_c).abs().max()))
            torch.testing.assert_close(grad_g, grad_c, rtol=1e-3, atol=floor, msg=lambda m: (
                f"{opt_name} {key}: |g| max {float(grad_c.abs().max()):.3e}, card-CPU "
                f"{float((grad_g - grad_c).abs().max()):.3e}, floor {floor:.3e}\n{m}"))
            torch.testing.assert_close(after_g, _adam_first_step(before_g, grad_g, cfg),
                                       rtol=1e-6, atol=1e-7, msg=lambda m: f"{key}: {m}")
        print(f"{name} {opt_name}: card-CPU gradients differ by at most " + ", ".join(
            f"{role} {worst[role] / largest[role]:.3e}" for role in worst)
            + f" of the largest; floor {share:.0e}")
    for role, m in mods_g.items():
        stats_g = d_stats_g.get(role) or m.state_dict()
        stats_c = d_stats_c.get(role) or mods_c[role].state_dict()
        for k, v in stats_g.items():
            if "running" in k:
                torch.testing.assert_close(v.cpu(), stats_c[k], rtol=1e-4,
                                           atol=IM2IM_STATS_ATOL,
                                           msg=lambda m, k=k: f"{role} {k}: {m}")


# --- stargan, unit and pixelda: the IN pair at their sites ----------------------


def _new_sites():
    import chip_smoke

    return sorted({site for path in chip_smoke.NEW_IN_PATHS for unit in chip_smoke.IM2IM_IN[path]
                   for site in chip_smoke.im2im_sites(path, unit)})


@pytest.mark.parametrize("shape,slope", _new_sites())
def test_new_path_sites_match_plain_version(cuda, shape, slope):
    """Every (shape, slope) site of the stargan, unit and pixelda paths at
    their reference batches, forward and backward, repeating bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    y, mean, rstd = tin.in_act_fwd(x, 1e-5, slope)
    dx = tin.in_act_bwd(g, x, mean, rstd, slope)
    assert all(torch.equal(a, b) for a, b in zip((y, mean, rstd), tin.in_act_fwd(x, 1e-5, slope)))
    assert torch.equal(dx, tin.in_act_bwd(g, x, mean, rstd, slope))
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, 1e-5, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean, rstd, slope)
    torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(dx, dx_r, rtol=0, atol=1e-4 * float(dx_r.abs().max()))


def test_new_path_steps_launch_every_site_through_the_kernels(cuda):
    """stargan's d_step and g_step at 64px and unit's step at 64px, batch 1,
    and pixelda's step at 32px, batch 4: the IN launches of chip_smoke's
    site lists, each way."""
    import numpy as np

    import chip_smoke
    from tpugan_torch.models import pixelda, stargan, unit

    rng = np.random.default_rng(0)
    u8 = lambda *s: torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(cuda)
    per = lambda path, u, d: chip_smoke.im2im_per_unit(path, u, d)

    def launched(run):
        tracing.reset()
        run()
        torch.cuda.synchronize()
        return launches("in.fwd", "in.bwd")

    cfg = stargan.Config(batch_size=1, img_height=64, img_width=64)
    state = stargan.create_state(cfg, stargan.build(cfg, cuda), cuda)
    d_step, g_step = stargan.make_steps(cfg, state)
    x, labels = u8(1, 64, 64, 3), torch.zeros(1, 5, device=cuda)
    out = {}
    assert launched(lambda: out.update(d_step(state, x, labels)[1])) == (17, 0)
    assert launched(lambda: g_step(state, x, labels, out["sampled_c"])) == (34, 34)
    cfg = unit.Config(img_height=64, img_width=64)
    state = unit.create_state(cfg, unit.build(cfg, cuda), cuda)
    step = unit.make_step(cfg, state)
    x = u8(1, 64, 64, 3)
    assert launched(lambda: step(state, x, x)) == (per("unit", "step", "fwd"),) * 2
    cfg = pixelda.Config(batch_size=4)
    state = pixelda.create_state(cfg, pixelda.build(cfg, cuda), cuda)
    step = pixelda.make_step(cfg, state)
    x, y = u8(4, 32, 32, 3), torch.zeros(4, dtype=torch.int32, device=cuda)
    want = (per("pixelda", "step", "fwd") + per("pixelda", "telemetry", "fwd"),
            per("pixelda", "step", "bwd"))
    assert launched(lambda: step(state, x, y, x, y)) == want


def test_tracked_in_on_the_card_matches_the_cpu(cuda):
    """stargan's tracked affine IN at (16, 256, 32, 32): the card's
    train-mode y, running buffers and input gradient against the same layer
    on the CPU, and the eval-mode y; fp32 with sums in different orders: y
    and dx 1e-5 absolute, buffers 1e-6 absolute plus 1e-5 relative."""
    from tpugan_torch.nn.layers import InstanceNorm

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(16, 256, 32, 32, generator=gen) * 2 + 0.5
    g = torch.randn(x.shape, generator=gen)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        layer = InstanceNorm(256, affine=True, track_running_stats=True).to(dev)
        xd = x.detach().clone().to(dev).requires_grad_(True)
        y = layer(xd)
        (y * g.to(dev)).sum().backward()
        layer.eval()
        with torch.no_grad():
            y_eval = layer(x.to(dev))
        outs.append([t.detach().cpu() for t in (y, xd.grad, layer.running_mean,
                                                 layer.running_var, y_eval)])
    for name, a, b in zip(("y", "dx", "running_mean", "running_var", "eval y"), *outs):
        tol = dict(rtol=1e-5, atol=1e-6) if "running" in name else dict(rtol=0, atol=1e-5)
        torch.testing.assert_close(b, a, **tol, msg=name)


# --- began and cluster_gan: one step; began replayed -----------------------------
#
# Each at its reference configuration, from the same weights, batch and draws
# on both devices, as the im2im steps: losses 1e-4 relative; each optimizer's
# gradients 1e-3 relative plus ``IM2IM_FLOORS`` (5e-3) of its module's
# largest CPU gradient, since began's and ebgan's discriminators normalize
# features whose batch mean is up to ~1e3 times their spread (BatchNorm1d
# after Linear(32 -> 64 * 16 * 16)), where a float32 rounding of the Linear
# moves the normalized value by up to 1e-3 (the CPU tests measured JAX's
# began G gradients 4.8e-4 of the largest from float64); Adam's first step
# of the card's own gradients (cluster_gan's "ge" with its weight decay);
# running statistics 1e-4 relative and ``IM2IM_STATS_ATOL`` absolute; no
# kernel of the port launched.


@pytest.mark.parametrize("name", ["began", "cluster_gan"])
def test_one_template_rest_step_on_the_card_matches_the_cpu(cuda, name):
    import importlib

    import numpy as np

    mod = importlib.import_module(f"tpugan_torch.models.{name}")
    cfg = mod.Config(synthetic_data=True, **({"wass_flag": True} if name == "cluster_gan" else {}))
    b, size = cfg.batch_size, cfg.img_size
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (b, size, size, 1),
                                                              dtype=np.uint8))
    g = torch.Generator().manual_seed(1)
    if name == "began":
        kw = {"z": torch.randn(b, cfg.latent_dim, generator=g)}
    else:
        kw = {"zn": 0.75 * torch.randn(b, cfg.latent_dim, generator=g),
              "zc_idx": torch.randint(0, mod.N_C, (b,), generator=g),
              "alpha": torch.rand(b, 1, 1, 1, generator=g)}
    decay = {"ge": mod.DECAY} if name == "cluster_gan" else {}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    runs = []
    try:
        for dev in (torch.device("cpu"), cuda):
            modules = mod.build(cfg, dev)
            state = mod.create_state(cfg, modules, dev)
            rec = _record_updates(state)
            step = mod.make_step(cfg, state) if name == "began" else mod.make_steps(cfg, state)[0]
            state, out = step(state, imgs.to(dev), None, **{k: v.to(dev) for k, v in kw.items()})
            runs.append((modules, rec, {k: v.cpu() for k, v in out.items() if v.ndim == 0}))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert counts == launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    (mods_c, rec_c, out_c), (mods_g, rec_g, out_g) = runs
    assert sorted(out_c) == sorted(out_g)
    for k in out_c:
        torch.testing.assert_close(out_g[k], out_c[k], rtol=1e-4, atol=0, msg=k)
    for opt_name, want in rec_c.items():
        got = rec_g[opt_name]
        largest = {}
        for (role, _), (_, grad, _) in want.items():
            if grad is not None:
                largest[role] = max(largest.get(role, 0.0), float(grad.abs().max()))
        worst, share = {}, IM2IM_FLOORS.get(opt_name, IM2IM_FLOORS["generator"])
        for key, (before_c, grad_c, _) in want.items():
            before_g, grad_g, after_g = got[key]
            if grad_c is None:
                assert grad_g is None, (opt_name, key)
                continue
            role = key[0]
            floor = share * largest[role]
            worst[role] = max(worst.get(role, 0.0), float((grad_g - grad_c).abs().max()))
            torch.testing.assert_close(grad_g, grad_c, rtol=1e-3, atol=floor, msg=lambda m: (
                f"{opt_name} {key}: |g| max {float(grad_c.abs().max()):.3e}, card-CPU "
                f"{float((grad_g - grad_c).abs().max()):.3e}, floor {floor:.3e}\n{m}"))
            adam = _adam_first_step(before_g, grad_g, cfg, weight_decay=decay.get(opt_name, 0.0))
            torch.testing.assert_close(after_g, adam, rtol=1e-6, atol=1e-7,
                                       msg=lambda m: f"{key}: {m}")
        print(f"{name} {opt_name}: card-CPU gradients differ by at most " + ", ".join(
            f"{role} {worst[role] / largest[role]:.3e}" for role in worst)
            + f" of the largest; floor {share:.0e}")
    for role, m in mods_g.items():
        stats_c = mods_c[role].state_dict()
        for k, v in m.state_dict().items():
            if "running" in k:
                torch.testing.assert_close(v.cpu(), stats_c[k], rtol=1e-4, atol=IM2IM_STATS_ATOL,
                                           msg=lambda m, k=k: f"{role} {k}: {m}")


def test_replayed_began_steps_equal_eager_steps_with_deterministic_cudnn(cuda, monkeypatch):
    """began at its reference configuration, K = 3, with cuDNN held to
    deterministic algorithms: the eager runs agree bit for bit, and so must
    the replay, on every tensor, the equilibrium term k in ``state.aux``
    (updated in place inside the graph) among them."""
    import numpy as np

    from tpugan_torch.models import began

    k = 3
    cfg = began.Config(synthetic_data=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def make():
        state = began.create_state(cfg, began.build(cfg, cuda), cuda)
        return state, began.make_step(cfg, state)

    batches = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, k, cfg.batch_size, 32, 32, 1), dtype=np.uint8)).to(cuda)
    (a, b), replay, _ = _fused_against_eager(make, k, batches, n_eager=2)
    assert "aux.k" in a and float(a["aux.k"]) > 0
    for name in a:
        assert torch.equal(b[name], a[name]), f"{name}: the eager runs differ"
        assert torch.equal(replay[name], a[name]), f"{name}: the replay differs"


# --- bicyclegan, srgan and esrgan: one step ---------------------------------------
#
# Each at its reference configuration (bicyclegan 128px, batch 8; srgan and
# esrgan HR 256, batch 4, 16 and 23 residual blocks), from the same weights,
# batch and draws (bicyclegan's eps and z) on both devices, as the im2im
# steps: losses 1e-4 relative; each optimizer's gradients 1e-3 relative plus
# ``IM2IM_FLOORS`` (5e-3) of its module's largest CPU gradient; Adam's first
# step of the card's own gradients; running statistics 1e-4 relative and
# ``IM2IM_STATS_ATOL`` absolute; no kernel of the port launched. The CPU
# tests found two float32 hazards on these paths, each held there in float64
# (``tests/test_torch_port_sr.py:_esrgan``,
# ``tests/test_torch_port_bicyclegan.py:_step``): a BatchNorm channel of
# esrgan's discriminator with a variance below its eps on the untrained
# generator's fakes, and bicyclegan's latent loss, read through the
# encoder after Adam's first step, lr * g / (|g| + eps), which turns the
# rounding of its near-zero gradients into steps of up to lr (on the card
# that moved 14 of the generator's first-conv gradients by up to 6.7e-3 of
# the largest). So the card's bicyclegan step takes the CPU run's updated
# encoder after recording its own update, which Adam's identity still
# holds. The test prints each measured card-CPU share.

SR_STEPS = ["bicyclegan", "srgan", "esrgan_warmup", "esrgan_full"]


def _take_after_step(state, name, want):
    """After optimizer ``name``'s own step (recorded), its parameters take the
    values ``want`` recorded (``_record_updates``: (role, key) -> (before,
    grad, after)), as the CPU tests' bicyclegan phase 2 takes JAX's updated
    encoder."""
    opt, recorded = state.optimizers[name], state.optimizers[name].step
    module = state.modules[name]

    def step(*a, **kw):
        out = recorded(*a, **kw)
        with torch.no_grad():
            for k, p in module.named_parameters():
                p.copy_(want[name, k][2])
        return out

    opt.step = step


@pytest.mark.parametrize("name", SR_STEPS)
def test_one_sr_or_bicyclegan_step_on_the_card_matches_the_cpu(cuda, name):
    import importlib

    import numpy as np

    mod = importlib.import_module(f"tpugan_torch.models.{name.split('_')[0]}")
    cfg = mod.Config(synthetic_data=True)
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(1)
    if name == "bicyclegan":
        shape = (cfg.batch_size, cfg.img_height, cfg.img_width, cfg.channels)
        batch = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)) for _ in range(2)]
        kw = {k: torch.randn(cfg.batch_size, cfg.latent_dim, generator=g)
              for k in ("eps", "sampled_z")}
    else:
        shape = (cfg.batch_size, cfg.hr_height, cfg.hr_height, cfg.channels)
        batch, kw = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))], {}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    runs = []
    try:
        for dev in (torch.device("cpu"), cuda):
            modules = mod.build(cfg, dev)
            state = mod.create_state(cfg, modules, dev)
            rec = _record_updates(state)
            if name == "bicyclegan" and runs:  # phase 2 reads the CPU's updated encoder
                _take_after_step(state, "encoder", runs[0][1]["encoder"])
            if name.startswith("esrgan"):
                step = mod.make_steps(cfg, state)[name.endswith("full")]
            else:
                step = mod.make_step(cfg, state)
            state, out = step(state, *[x.to(dev) for x in batch],
                              **{k: v.to(dev) for k, v in kw.items()})
            runs.append((modules, rec, {k: v.cpu() for k, v in out.items() if v.ndim == 0}))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert counts == launches("in.fwd", "in.bwd", "adain.fwd", "gp.fwd")
    (mods_c, rec_c, out_c), (mods_g, rec_g, out_g) = runs
    assert sorted(out_c) == sorted(out_g) and sorted(rec_c) == sorted(rec_g)
    for k in out_c:
        torch.testing.assert_close(out_g[k], out_c[k], rtol=1e-4, atol=0, msg=k)
    share = IM2IM_FLOORS["generator"]
    for opt_name, want in rec_c.items():
        got = rec_g[opt_name]
        largest = {}
        for (role, _), (_, grad, _) in want.items():
            if grad is not None:
                largest[role] = max(largest.get(role, 0.0), float(grad.abs().max()))
        worst = {}
        for key, (before_c, grad_c, _) in want.items():
            before_g, grad_g, after_g = got[key]
            if grad_c is None:
                assert grad_g is None, (opt_name, key)
                continue
            role = key[0]
            floor = share * largest[role]
            worst[role] = max(worst.get(role, 0.0), float((grad_g - grad_c).abs().max()))
            torch.testing.assert_close(grad_g, grad_c, rtol=1e-3, atol=floor, msg=lambda m: (
                f"{opt_name} {key}: |g| max {float(grad_c.abs().max()):.3e}, card-CPU "
                f"{float((grad_g - grad_c).abs().max()):.3e}, floor {floor:.3e}\n{m}"))
            torch.testing.assert_close(after_g, _adam_first_step(before_g, grad_g, cfg),
                                       rtol=1e-6, atol=1e-7, msg=lambda m: f"{key}: {m}")
        print(f"{name} {opt_name}: card-CPU gradients differ by at most " + ", ".join(
            f"{role} {worst[role] / largest[role]:.3e}" for role in worst)
            + f" of the largest; floor {share:.0e}")
    for role, m in mods_g.items():
        stats_c = mods_c[role].state_dict()
        for k, v in m.state_dict().items():
            if "running" in k:
                torch.testing.assert_close(v.cpu(), stats_c[k], rtol=1e-4, atol=IM2IM_STATS_ATOL,
                                           msg=lambda m, k=k: f"{role} {k}: {m}")


def test_resize_bicubic_on_the_card_matches_the_cpu(cuda):
    """srgan's LR/HR pair from one uint8 batch at HR 256 (4x down, and the
    HR resize to its own size) and a 2x enlargement, card against CPU: the
    antialiased bicubic, 1e-6 absolute on [0, 1] images (the CPU tests hold
    the CPU's to ``jax.image.resize`` at 1e-6)."""
    import numpy as np

    from tpugan_torch.models.srgan import prepare_lr_hr
    from tpugan_torch.ops.image import resize_bicubic

    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (4, 256, 256, 3),
                                                            dtype=np.uint8))
    for got, want in zip(prepare_lr_hr(u8.to(cuda), 256), prepare_lr_hr(u8, 256)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6 * scale)
    x = u8.permute(0, 3, 1, 2).float() / 255.0
    torch.testing.assert_close(resize_bicubic(x.to(cuda), (512, 512)).cpu(),
                               resize_bicubic(x, (512, 512)), rtol=0, atol=1e-6)
    assert torch.equal(resize_bicubic(x.to(cuda), (64, 64)).cpu(),
                       resize_bicubic(x.to(cuda), (64, 64)).cpu())


# --- --dtype bfloat16: the bf16 forms and a bf16 step --------------------------


def _assert_within_bf16(got, want, atol):
    """Every element within one bf16 ulp of the larger magnitude plus
    ``atol`` (``chip_smoke._bf16_errors``)."""
    from chip_smoke import _bf16_errors

    err, share, ok = _bf16_errors(got, want, atol)
    assert ok, f"max |diff| {err:.3g}: {share:.2f} of the tolerance (one bf16 ulp + {atol:.3g})"


@pytest.mark.parametrize("slope", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("shape", IN_SHAPES + [(2, 8, 30, 30)])
def test_bf16_kernels_match_plain_version(cuda, shape, slope):
    """(2, 8, 30, 30): H*W % 8 = 4, the bf16 form's scalar fill where the
    float32 one loads float4s."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, device=cuda, generator=gen).bfloat16()
    g = torch.randn(shape, device=cuda, generator=gen).bfloat16()
    counts = lambda: launches("in.fwd", "in.bwd", "in.fwd.bf16", "in.bwd.bf16")
    before = counts()
    y, mean, rstd = tin.in_act_fwd(x, 1e-5, slope)
    dx = tin.in_act_bwd(g, x, mean, rstd, slope)
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    assert (y.dtype, dx.dtype) == (torch.bfloat16,) * 2
    assert (mean.dtype, rstd.dtype) == (torch.float32,) * 2
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, 1e-5, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean, rstd, slope)
    _assert_within_bf16(y, y_r, 1e-5)
    torch.testing.assert_close(mean, mean_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    _assert_within_bf16(dx, dx_r, 1e-4 * float(dx_r.float().abs().max()))
    assert torch.equal(y, tin.in_act_fwd(x, 1e-5, slope)[0])
    assert torch.equal(dx, tin.in_act_bwd(g, x, mean, rstd, slope))


@pytest.mark.parametrize("shape", [(1, 256, 32, 32), (40, 256, 32, 32), (2, 8, 31, 31),
                                   (1, 64, 128, 128)])
def test_bf16_adain_kernels_match_plain_version(cuda, shape):
    x, w, bias, g = (t.bfloat16() for t in _adain_inputs(shape, cuda))
    before = launches("adain.fwd.bf16", "adain.bwd.bf16")
    y, mean, rstd = ta.adain_fwd(x, w, bias, 1e-5)
    grads = ta.adain_bwd(g, x, w, mean, rstd)
    assert launches("adain.fwd.bf16", "adain.bwd.bf16") == (before[0] + 1, before[1] + 1)
    assert {t.dtype for t in (y, *grads)} == {torch.bfloat16}
    y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w, bias, 1e-5)
    _assert_within_bf16(y, y_r, 1e-5 * max(1.0, float(w.float().abs().max())))
    torch.testing.assert_close(mean, mean_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    for got, want in zip(grads, ta.adain_bwd_ref(g, x, w, mean, rstd)):
        _assert_within_bf16(got, want, 1e-4 * float(want.float().abs().max()) + 1e-7)


def test_bf16_kernels_take_no_mixed_call(cuda):
    """A bf16 map with a float32 gradient is refused, not widened to reach
    the float32 kernel."""
    x = torch.randn(2, 4, 8, 8, device=cuda).bfloat16()
    _, mean, rstd = tin.in_act_fwd(x, 1e-5, 0.0)
    with pytest.raises(TypeError):
        tin.in_act_bwd(torch.ones_like(x, dtype=torch.float32), x, mean, rstd, 0.0)
    with pytest.raises(TypeError):
        tin.in_act_bwd(torch.ones_like(x), x, mean.bfloat16(), rstd, 0.0)


def test_bf16_cyclegan_step_on_the_card_matches_the_cpu(cuda):
    """One CycleGAN step under ``--dtype bfloat16`` at 64px with 2 residual
    blocks from the same weights and batch, on the card and on the CPU, held
    at the scale of bf16's own rounding, which is large in this step (a bf16
    and a float32 step on the CPU differ by about a quarter of each
    generator's gradient norm): each loss within twice its bf16-float32
    difference on the CPU plus 1e-3 relative, each module's gradient (all of
    its parameters' as one vector) within twice that difference's norm.
    Every IN site goes through the bf16 kernels (48 each way: 4 generator
    forwards of 9 sites and 4 PatchGAN forwards of 3), none through the
    float32 ones; the parameters stay float32."""
    import numpy as np

    from tpugan_torch.models import cyclegan
    from tpugan_torch.nn.layers import set_default_compute_dtype

    cfg = cyclegan.Config(img_height=64, img_width=64, n_residual_blocks=2, synthetic_data=True)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
            for _ in "ab")
    cpu = torch.device("cpu")
    got = {}
    try:
        for key, dev, dtype in (("fp32", cpu, None), ("cpu", cpu, torch.bfloat16),
                                ("cuda", cuda, torch.bfloat16)):
            set_default_compute_dtype(dtype)
            modules = cyclegan.build(cfg, dev)
            state = cyclegan.create_state(cfg, modules, dev)
            tracing.reset()
            state, out = cyclegan.make_step(cfg, modules, dev)(state, a, b)
            got[key] = ({k: float(v) for k, v in out.items()},
                        {name: torch.cat([p.grad.float().cpu().flatten() for p in m.parameters()])
                         for name, m in modules.items()})
            assert {p.dtype for m in modules.values() for p in m.parameters()} == {torch.float32}
    finally:
        set_default_compute_dtype(None)
    assert launches("in.fwd.bf16", "in.bwd.bf16") == (48, 48)
    assert launches("in.fwd", "in.bwd") == (0, 0)
    (loss_f, grad_f), (loss_c, grad_c), (loss_g, grad_g) = got["fp32"], got["cpu"], got["cuda"]
    for k, v in loss_c.items():
        assert abs(loss_g[k] - v) <= 2 * abs(v - loss_f[k]) + 1e-3 * abs(v), (k, loss_g[k], v)
    for name in grad_c:
        diff = float((grad_g[name] - grad_c[name]).norm())
        scale = float((grad_c[name] - grad_f[name]).norm())
        print(f"{name}: card-CPU bf16 gradient difference {diff:.3g}, CPU bf16-fp32 {scale:.3g}, "
              f"norm {float(grad_c[name].norm()):.3g}")
        assert diff <= 2 * scale, name


def _dp_dcgan_rank(rank, port, imgs, results):
    """One rank of ``test_two_gloo_ranks_on_the_card_match_one_process``."""
    import traceback

    import torch.distributed as dist

    from tpugan_torch.models import dcgan
    from tpugan_torch.parallel.mesh import auto_sharding, local_rows, replicate_for
    from tpugan_torch.train.loop import card_device

    try:
        dev = card_device(torch.device("cuda", 0))  # fp32: TF32 off
        torch.cuda.set_device(dev)
        torch.backends.cudnn.deterministic = True
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2)
        try:
            cfg = dcgan.Config(img_size=64, synthetic_data=True)
            state = replicate_for(auto_sharding(cfg.batch_size, dev),
                                  dcgan.create_state(cfg, dcgan.build(cfg, dev), dev))
            imgs = local_rows(state.dp, torch.from_numpy(imgs)).to(dev)
            state, out = dcgan.make_step(cfg, state)(state, imgs)
            # numpy through the queue: torch's own tensor pickling passes
            # file descriptors, which a sandboxed host may refuse.
            results.put((rank, {"d_loss": float(out["d_loss"]), "g_loss": float(out["g_loss"]),
                                "state": {f"{r}.{k}": v.cpu().numpy()
                                          for r, m in state.modules.items()
                                          for k, v in m.state_dict().items()},
                                "grads": {f"{r}.{k}": p.grad.cpu().numpy()
                                          for r, m in state.modules.items()
                                          for k, p in m.named_parameters()}}))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the test
        results.put((rank, traceback.format_exc()))


def test_two_gloo_ranks_on_the_card_match_one_process(cuda, monkeypatch):
    """One DCGAN step at 64px, batch 64, on two gloo ranks sharing the card
    (global BatchNorm, the gradient mean, each rank's rows of the draws),
    against one process on the card from the same seed, fp32 with TF32 off
    and cuDNN held deterministic on both sides: losses 1e-4 relative, gradients 1e-3
    relative plus 1e-3 of the module's largest, parameters 1e-5 absolute
    where the gradient is above that floor and above 100x Adam's eps, 2*lr
    elsewhere (the step tolerances above), both ranks' states bit for bit.
    The test prints each module's largest gradient difference as a share of
    its largest gradient."""
    import multiprocessing

    from tpugan_torch.models import dcgan
    from tpugan_torch.parallel.dryrun import free_port

    cfg = dcgan.Config(img_size=64, synthetic_data=True)
    imgs = torch.randint(0, 256, (cfg.batch_size, 64, 64, 1), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_dp_dcgan_rank, args=(r, port, imgs.numpy(), results))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank, r in got.items():
        assert isinstance(r, dict), f"rank {rank} failed:\n{r}"
        for part in ("state", "grads"):
            r[part] = {k: torch.from_numpy(v) for k, v in r[part].items()}
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    state = dcgan.create_state(cfg, dcgan.build(cfg, cuda), cuda)
    state, out = dcgan.make_step(cfg, state)(state, imgs.to(cuda))
    want = {f"{r}.{k}": v.cpu() for r, m in state.modules.items()
            for k, v in m.state_dict().items()}
    want_grads = {f"{r}.{k}": p.grad.cpu() for r, m in state.modules.items()
                  for k, p in m.named_parameters()}
    r0, r1 = got[0], got[1]
    for k in ("d_loss", "g_loss"):
        assert r0[k] == r1[k]
        assert abs(r0[k] - float(out[k])) <= 1e-4 * abs(float(out[k])), k
    largest = {}
    for k, g in r0["grads"].items():
        role = k.split(".")[0]
        largest[role] = max(largest.get(role, 0.0), float(g.abs().max()))
    for role, top in largest.items():
        share = max(float((r0["grads"][k] - want_grads[k]).abs().max())
                    for k in want_grads if k.startswith(role + ".")) / top
        print(f"{role}: largest gradient difference {share:.3e} of its largest gradient")
    for k, g in want_grads.items():
        torch.testing.assert_close(r0["grads"][k], g, rtol=1e-3,
                                   atol=1e-3 * largest[k.split(".")[0]], msg=lambda m: f"{k}: {m}")
    for k, w in want.items():
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        if k.endswith("num_batches_tracked"):
            assert int(r0["state"][k]) == int(w), k
            continue
        diff = (r0["state"][k] - w).abs()
        if k in r0["grads"]:
            g = r0["grads"][k].abs()
            quiet = (g <= 1e-3 * largest[k.split(".")[0]]) | (g <= 100 * 1e-8)
            bound = torch.where(quiet, torch.full_like(w, 2 * cfg.lr + 1e-5),
                                torch.full_like(w, 1e-5))
        else:  # running statistics
            bound = 1e-5 + 1e-4 * w.abs()
        assert not (diff > bound).any(), f"{k}: off by {float(diff.max()):.3e}"
