"""DCGAN (Radford et al. 2016): the port of ``tpugan/models/dcgan.py``.

Conv G (Linear, view, 2 x [Upsample, Conv3x3, BatchNorm2d(eps=0.8),
LeakyReLU], Conv, Tanh; dcgan.py:45-71) and conv D (4 stride-2 conv blocks
with Dropout2d and BatchNorm2d; dcgan.py:74-99) on MNIST at 32px, BCE, 1:1
Adam updates (dcgan.py:143-183), ``weights_init_normal`` on both
(dcgan.py:36-42). At 64px, batch 64, this is the headline throughput
workload (``tpugan_torch/bench.py``).

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from tpugan_torch.losses import bce
from tpugan_torch.models._common import mnist_loader, run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b, make_step_b
from tpugan_torch.nn.blocks import DCGANDiscriminator, DCGANGenerator
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "dcgan"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with dcgan.py:20-32 and tpugan.models.dcgan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "interval between image sampling")


def build(cfg: Config, device, first_bn: bool = True, sigmoid: bool = True) -> dict:
    """G and D with weights drawn from a generator seeded by ``--seed`` (on
    the CPU, so they do not depend on the device). ``first_bn`` and
    ``sigmoid`` False give lsgan's networks."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": DCGANGenerator(cfg.img_size, cfg.channels, cfg.latent_dim,
                                    first_bn=first_bn, generator=gen),
        "discriminator": DCGANDiscriminator(cfg.img_size, cfg.channels, sigmoid=sigmoid,
                                            generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = mnist_loader


def make_step(cfg: Config, state):
    return make_step_b(cfg, state, bce)


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__], device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
