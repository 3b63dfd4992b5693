"""LSGAN (Mao et al. 2017), least-squares GAN: the port of
``tpugan/models/lsgan.py``.

The DCGAN template with the MSE adversarial loss (lsgan.py:101-102), a
generator without the first BatchNorm (lsgan.py:52-70) and a discriminator
head without the Sigmoid (lsgan.py:90-96); ``weights_init_normal`` on both
(lsgan.py:114-115). Flags and defaults are DCGAN's (lsgan.py:20-32).
"""

from __future__ import annotations

import dataclasses
import sys

from tpugan_torch.losses import mse
from tpugan_torch.models import dcgan as _dcgan
from tpugan_torch.models._common import run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b, make_step_b
from tpugan_torch.utils.config import config_from_args

NAME = "lsgan"


@dataclasses.dataclass
class Config(_dcgan.Config):
    pass


def build(cfg: Config, device) -> dict:
    return _dcgan.build(cfg, device, first_bn=False, sigmoid=False)


create_state = create_state_b
make_loader = _dcgan.make_loader


def make_step(cfg: Config, state):
    return make_step_b(cfg, state, mse)


def run(cfg: Config, device=None):
    return run_mnist_recipe(cfg, sys.modules[__name__], device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
