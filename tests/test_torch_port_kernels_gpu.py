"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the launch counts of one CycleGAN step, one WGAN-GP critic step
and one MUNIT step.

These need a CUDA device and skip without one. The file imports no JAX, so
it also runs where JAX is not installed; there, skip the JAX-importing
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels_gpu.py

Tolerances as in ``chip_smoke.py``: fp32 with sums in different orders,
1e-5 absolute on y and 1e-4 of the largest |dx| on dx for instance norm; for
the GP pair 1e-5 of the largest |g| on g and t, and 1e-4 of the largest
entry on each weight gradient; for AdaIN 1e-5 * max(1, max|w|) absolute on y
and 1e-4 of the largest |.| on each of dx, dw and dbias.
"""

import pytest
import torch

from tpugan_torch.ops import adain as ta
from tpugan_torch.ops import instance_norm as tin
from tpugan_torch.ops import mlp_gp as gp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("slope", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("shape", [(2, 64, 32, 32), (1, 256, 16, 16), (2, 8, 31, 31), (3, 5, 1, 7),
                                   (1, 128, 8, 8), (1, 512, 2, 2)])
def test_kernels_match_plain_version(cuda, shape, slope):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=gen)
    g = torch.randn(shape, device=cuda, generator=gen)
    before = (tin.fwd_launches, tin.bwd_launches)
    y, mean, rstd = tin.in_act_fwd(x, 1e-5, slope)
    dx = tin.in_act_bwd(g, x, mean, rstd, slope)
    assert (tin.fwd_launches, tin.bwd_launches) == (before[0] + 1, before[1] + 1)
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, 1e-5, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean, rstd, slope)
    torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, mean_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(dx, dx_r, rtol=0, atol=1e-4 * float(dx_r.abs().max()))


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
    tin.reset_launch_counts()
    state, out = step(state, a, b)
    torch.cuda.synchronize()
    assert (tin.fwd_launches, tin.bwd_launches) == (104, 104)
    assert all(torch.isfinite(v) for v in out.values())


def _gp_inputs(shape, device, seed=0):
    b, n0, n1, n2 = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*dims, fan_in=1):
        return (torch.rand(dims, device=device, generator=gen) * 2 - 1) / fan_in ** 0.5

    return (u(b, n0), u(n1, n0, fan_in=n0), u(n1, fan_in=n0), u(n2, n1, fan_in=n1),
            u(n2, fan_in=n1), u(1, n2, fan_in=n2))


@pytest.mark.parametrize("shape", [(64, 784, 512, 256), (1, 784, 512, 256), (7, 13, 100, 36)])
def test_gp_kernels_match_plain_version(cuda, shape):
    ins = _gp_inputs(shape, cuda)
    before = (gp.gp_fwd_launches, gp.gp_bwd_launches)
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
    assert (gp.gp_fwd_launches, gp.gp_bwd_launches) == (before[0] + 1, before[1] + 1)


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


def test_one_wgan_gp_d_step_launches_the_gp_pair_once(cuda):
    import numpy as np

    from tpugan_torch.models import wgan_gp

    cfg = wgan_gp.Config()
    modules = wgan_gp.build(cfg, cuda)
    state = wgan_gp.create_state(cfg, modules, cuda)
    d_step, _ = wgan_gp.make_steps(cfg, state)
    imgs = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (64, 28, 28, 1), dtype=np.uint8))
    gp.reset_launch_counts()
    state, out = d_step(state, imgs)
    torch.cuda.synchronize()
    assert (gp.gp_fwd_launches, gp.gp_bwd_launches) == (1, 1)
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
                                   (2, 4, 1, 1)])
def test_adain_kernels_match_plain_version(cuda, shape):
    x, w, bias, g = _adain_inputs(shape, cuda)
    before = (ta.adain_fwd_launches, ta.adain_bwd_launches)
    y, mean, rstd = ta.adain_fwd(x, w, bias, 1e-5)
    grads = ta.adain_bwd(g, x, w, mean, rstd)
    assert (ta.adain_fwd_launches, ta.adain_bwd_launches) == (before[0] + 1, before[1] + 1)
    y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w, bias, 1e-5)
    torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())))
    torch.testing.assert_close(mean, mean_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    for a, b in zip(grads, ta.adain_bwd_ref(g, x, w, mean, rstd)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)


def test_adain_kernels_reject_what_they_do_not_take(cuda):
    x, w, bias, g = _adain_inputs((2, 4, 8, 8), cuda)
    with pytest.raises(TypeError):
        ta.adain_fwd(x.double(), w, bias, 1e-5)
    with pytest.raises(ValueError):
        ta.adain_fwd(x.transpose(2, 3), w, bias, 1e-5)
    wide = torch.randn(2, 16, device=cuda)
    with pytest.raises(ValueError):
        ta.adain_fwd(x, wide[:, 4:8], bias, 1e-5)  # a strided slice: adain() copies it first
    _, mean, rstd = ta.adain_fwd(x, w, bias, 1e-5)
    with pytest.raises(TypeError):
        ta.adain_bwd(g.double(), x, w, mean, rstd)
    with pytest.raises(ValueError):
        ta.adain_bwd(g, x, wide[:, 4:8], mean, rstd)


def test_one_munit_step_launches_every_site_through_the_kernels(cuda):
    import numpy as np

    from tpugan_torch.models import munit

    cfg = munit.Config(img_height=64, img_width=64)
    modules = munit.build(cfg, cuda)
    state = munit.create_state(cfg, modules, cuda)
    step = munit.make_step(cfg, modules, cuda)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)) for _ in "ab")
    ta.reset_launch_counts()
    tin.reset_launch_counts()
    state, out = step(state, a, b)
    torch.cuda.synchronize()
    assert (ta.adain_fwd_launches, ta.adain_bwd_launches) == (24, 24)
    assert (tin.fwd_launches, tin.bwd_launches) == (90, 90)
    assert all(torch.isfinite(v) for v in out.values())
