"""Vanilla GAN (Goodfellow et al. 2014): the port of ``tpugan/models/gan.py``.

Template-A MLP generator and discriminator with the Sigmoid head on MNIST at
28x28 (gan/gan.py:38-81), BCE, 1:1 Adam(2e-4, 0.5, 0.999) updates, G first,
then D on the real batch and the G phase's fakes detached (gan.py:135-161);
the 5x5 sample grid every ``--sample_interval`` batches (gan.py:169-170).
The step is template B's (``_template_b.make_step_b``); the discriminator
has no dropout, so z is the step's only draw. No kernel of the port runs
here.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import torch

from tpugan_torch.losses import bce
from tpugan_torch.models._common import mnist_loader, run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b, make_step_b
from tpugan_torch.nn.blocks import MLPDiscriminator, MLPGenerator
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "gan"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with gan.py:19-31 and tpugan.models.gan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    img_size: int = flag(28, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "interval betwen image samples")


def build(cfg: Config, device) -> dict:
    """G and D with weights drawn from a generator seeded by ``--seed`` (on
    the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    img_shape = (cfg.channels, cfg.img_size, cfg.img_size)
    modules = {
        "generator": MLPGenerator(img_shape, cfg.latent_dim, generator=gen),
        "discriminator": MLPDiscriminator(math.prod(img_shape), sigmoid=True, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = mnist_loader


def make_step(cfg: Config, state):
    return make_step_b(cfg, state, bce)


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__], device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
