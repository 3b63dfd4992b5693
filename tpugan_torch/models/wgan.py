"""WGAN (Arjovsky et al. 2017): the port of ``tpugan/models/wgan.py``.

Template-A MLP generator and critic (no sigmoid, wgan.py:65-80),
RMSprop(5e-5) for both (wgan.py:105-106: alpha 0.99, eps 1e-8 outside the
sqrt, which ``rmsprop_torch`` reproduces in the JAX package; capturable on
CUDA), critic loss -mean(D(x)) + mean(D(G(z))) with every critic parameter
clamped to ±clip_value in place after each critic step (wgan.py:134-141),
generator every n_critic = 5 batches on the same z (wgan.py:144-157);
samples checked on every batch, batches_done advancing by 1
(wgan.py:160-166). The reference omits the Resize transform (wgan.py:95-99):
images stay 28px, the img_size default. No kernel of the port runs here.
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
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.optim import capturable, clip_params_
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "wgan"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with wgan.py:20-31 and tpugan.models.wgan.Config (no b1/b2:
    # RMSprop).
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.00005, "learning rate")
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
    rmsprop = lambda m: torch.optim.RMSprop(m.parameters(), lr=cfg.lr, alpha=0.99, eps=1e-8,
                                            **capturable(device))
    return create_state_a(
        cfg, modules, rmsprop(modules["generator"]), rmsprop(modules["discriminator"]), device
    )


def d_loss_fn(D, real, fake, alpha) -> torch.Tensor:
    """Critic loss (wgan.py:132); the d_step's ``alpha`` goes unused."""
    del alpha
    return -torch.mean(D(real).float()) + torch.mean(D(fake).float())


def make_steps(cfg: Config, state):
    clip = lambda D: clip_params_(D, cfg.clip_value)
    return (
        make_d_step(cfg, state.modules, state.optimizers["discriminator"], d_loss_fn,
                    post_update=clip),
        make_g_step(cfg, state.modules, state.optimizers["generator"]),
    )


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off for matmuls."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    state = create_state(cfg, modules, device)
    d_step, g_step = make_steps(cfg, state)
    return run_critic_family(cfg, state, d_step, g_step, sample_inside_gstep=False,
                             device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
