"""WGAN-div (Wu et al. 2018), the Wasserstein divergence: the port of
``tpugan/models/wgan_div.py``.

Template-A MLP generator and critic, Adam(2e-4, 0.5, 0.999) for both
(wgan_div.py:114-115; capturable on CUDA), critic loss -mean(D(x)) +
mean(D(G(z))) + the divergence penalty with k = 2, p = 6 on the real and the
fake batch (wgan_div.py:86-87,148-163), generator every n_critic = 5 batches
on the same z; batches_done advances by n_critic, as in wgan_gp. The
penalty is the generic double backward of ``ops.penalty.wdiv_penalty``, as
in the JAX package: the closed-form GP kernels compute another function and
are not used. The d_step draws z only (``make_d_step(draw_alpha=False)``).
No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses

import torch

from tpugan_torch.models import wgan_gp as _gp
from tpugan_torch.models._critic_family import (
    build_a,
    make_d_step,
    make_g_step,
    make_loader_a,
    run_critic_family,
)
from tpugan_torch.ops.penalty import wdiv_penalty
from tpugan_torch.train.loop import train_device
from tpugan_torch.utils.config import config_from_args

NAME = "wgan_div"
K, P = 2.0, 6.0  # wgan_div.py:86-87


@dataclasses.dataclass
class Config(_gp.Config):
    # Flag parity with wgan_div.py:22-33 (the set of wgan_gp).
    pass


build = build_a
create_state = _gp.create_state
make_loader = make_loader_a


def d_loss_fn(D, real, fake, alpha) -> torch.Tensor:
    """Critic loss (wgan_div.py:148-165); takes no alpha."""
    del alpha
    div = wdiv_penalty(D, real, fake, k=K, p=P)
    return -torch.mean(D(real).float()) + torch.mean(D(fake).float()) + div


def make_steps(cfg: Config, state):
    return (
        make_d_step(cfg, state.modules, state.optimizers["discriminator"], d_loss_fn,
                    draw_alpha=False),
        make_g_step(cfg, state.modules, state.optimizers["generator"]),
    )


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off for matmuls."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    state = create_state(cfg, modules, device)
    d_step, g_step = make_steps(cfg, state)
    return run_critic_family(cfg, state, d_step, g_step, sample_inside_gstep=True, device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
