"""WGAN-GP (Gulrajani et al. 2017): the port of ``tpugan/models/wgan_gp.py``.

Template-A MLP generator and critic, Adam(2e-4, 0.5, 0.999) for both
(wgan_gp.py:113-114; capturable on CUDA), critic loss -mean(D(x)) + mean(D(G(z))) + 10*GP
(wgan_gp.py:171) with the gradient penalty on alpha-interpolated samples
(wgan_gp.py:119-138), generator every n_critic = 5 batches on the same z
(wgan_gp.py:179-193); batches_done advances by n_critic (wgan_gp.py:203).

The penalty of the template-A critic is the closed form of
``tpugan_torch.ops.mlp_gp``: on CUDA it runs through the hand-written kernel
pair of ``csrc/mlp_gp.cu`` on every critic step, with no switch. Any other
critic takes the generic double-backward of ``tpugan_torch.ops.penalty``.
The JAX package's ``TPUGAN_PALLAS_GP`` opt-in does not carry over.
"""

from __future__ import annotations

import dataclasses

import torch

from tpugan_torch.models._critic_family import (
    build_a,
    create_state_a,
    make_d_step,
    make_g_step,
    make_loader_a,
    run_critic_family,
)
from tpugan_torch.ops.mlp_gp import extract_mlp_critic, mlp_grad_penalty
from tpugan_torch.ops.penalty import wgan_gp_penalty
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.optim import capturable
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "wgan_gp"
LAMBDA_GP = 10.0  # wgan_gp.py:87


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with wgan_gp.py:25-37 and tpugan.models.wgan_gp.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    img_size: int = flag(28, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    n_critic: int = flag(5, "number of training steps for discriminator per iter")
    clip_value: float = flag(0.01, "lower and upper clip value for disc. weights")
    sample_interval: int = flag(400, "interval betwen image samples")


build = build_a
make_loader = make_loader_a


def create_state(cfg: Config, modules: dict, device):
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                      **capturable(device))
    return create_state_a(
        cfg, modules, adam(modules["generator"]), adam(modules["discriminator"]), device
    )


def d_loss_fn(D, real, fake, alpha) -> torch.Tensor:
    """Critic loss (wgan_gp.py:165-171). The penalty is the closed form when
    ``D`` is the template-A critic, else the generic double-backward; both
    on the same interpolates."""
    leaves = extract_mlp_critic(D)
    if leaves is None:
        gp = wgan_gp_penalty(D, real, fake, alpha=alpha)
    else:
        interp = alpha * real + (1.0 - alpha) * fake
        gp = mlp_grad_penalty(interp.reshape(interp.shape[0], -1), *leaves)
    return -torch.mean(D(real).float()) + torch.mean(D(fake).float()) + LAMBDA_GP * gp


def make_steps(cfg: Config, state):
    return (
        make_d_step(cfg, state.modules, state.optimizers["discriminator"], d_loss_fn),
        make_g_step(cfg, state.modules, state.optimizers["generator"]),
    )


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off for convolutions and
    matmuls."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    state = create_state(cfg, modules, device)
    d_step, g_step = make_steps(cfg, state)
    return run_critic_family(cfg, state, d_step, g_step, sample_inside_gstep=True, device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
