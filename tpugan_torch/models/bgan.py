"""Boundary-Seeking GAN (Hjelm et al. 2017): the port of ``tpugan/models/bgan.py``.

gan's networks and data (template-A MLPs with the Sigmoid head, MNIST at
28x28, bgan.py:40-82) and its step (``_template_b.make_step_b``): G first
on the boundary-seeking loss 0.5 * mean((log D - log(1 - D))^2)
(bgan.py:85-90,148), then D on BCE over the real batch and the fakes
detached (bgan.py:157-165), 1:1 Adam(2e-4, 0.5, 0.999). The reference's
loop names an undefined loader (bgan.py:126); the port, as the JAX package,
runs the loop it means. No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import sys

from tpugan_torch.losses import bce, boundary_seeking
from tpugan_torch.models import gan as _gan
from tpugan_torch.models._common import run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b, make_step_b
from tpugan_torch.utils.config import config_from_args

NAME = "bgan"


@dataclasses.dataclass
class Config(_gan.Config):
    """Flag parity with bgan.py:21-31 (gan's set) and tpugan.models.bgan."""


build = _gan.build
create_state = create_state_b
make_loader = _gan.make_loader


def make_step(cfg: Config, state):
    return make_step_b(cfg, state, bce, g_loss=boundary_seeking)


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__], device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
