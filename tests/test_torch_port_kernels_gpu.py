"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the launch counts of one CycleGAN step.

These need a CUDA device and skip without one. The file imports no JAX, so
it also runs where JAX is not installed; there, skip the JAX-importing
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels_gpu.py

Tolerances as in ``chip_smoke.py``: fp32 with sums in different orders,
1e-5 absolute on y and 1e-4 of the largest |dx| on dx.
"""

import pytest
import torch

from tpugan_torch.ops import instance_norm as tin

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("slope", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("shape", [(2, 64, 32, 32), (1, 256, 16, 16), (2, 8, 31, 31), (3, 5, 1, 7)])
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
