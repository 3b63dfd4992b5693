"""Softmax GAN (Lin 2017): the port of ``tpugan/models/softmax_gan.py``.

Template-A MLP generator and a critic without the Sigmoid head
(softmax_gan.py:38-80), MNIST at 28x28, Adam(2e-4, 0.5, 0.999). One joint
forward a step (softmax_gan.py:125-159): D on the real batch and on G's
fakes, the batch partition Z = sum(exp(-d_real)) + sum(exp(-d_fake)), then
    d_loss = (1/B) * sum(d_real) + log(Z + 1e-8)
    g_loss = (1/2B) * (sum(d_real) + sum(d_fake)) + log(Z + 1e-8).

The reference zero-grads both optimizers once, backpropagates d_loss with
the graph retained, steps D, then backpropagates g_loss into the same
gradients and steps G: D steps on grad_D(d_loss) and G on grad_G(d_loss +
g_loss), both at the pre-update parameters (``tpugan/models/softmax_gan.py:
1-19``). Here each is one ``torch.autograd.grad`` of the one forward over
its own parameters. z is the step's only draw. No kernel of the port runs
here.

Under data parallelism (``tpugan/models/softmax_gan.py:104`` over a sharded
batch) Z is the global batch's partition, every rank summing the gathered
d_real and d_fake (``gather_rows``, whose backward carries each rank's
gradient of log Z to the rank that holds the logit), and the mean terms
(1/B) * sum stay each rank's mean over its rows; the optimizer hook's mean
over the ranks then gives the global losses' gradients.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional

import torch

from tpugan_torch.models import gan as _gan
from tpugan_torch.models._common import run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.nn.blocks import MLPDiscriminator, MLPGenerator
from tpugan_torch.parallel.mesh import (
    DataParallel,
    gather_rows,
    global_batch,
    global_means,
    local_rows,
)
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import config_from_args

NAME = "softmax_gan"


@dataclasses.dataclass
class Config(_gan.Config):
    """Flag parity with softmax_gan.py:19-29 (gan's set) and
    tpugan.models.softmax_gan."""


def build(cfg: Config, device) -> dict:
    """G and the critic (no Sigmoid: D's raw output is the energy), weights
    drawn from a generator seeded by ``--seed`` on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    img_shape = (cfg.channels, cfg.img_size, cfg.img_size)
    modules = {
        "generator": MLPGenerator(img_shape, cfg.latent_dim, generator=gen),
        "discriminator": MLPDiscriminator(math.prod(img_shape), sigmoid=False, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = _gan.make_loader


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x + 1e-8)  # softmax_gan.py:117-118


def log_partition(dp: Optional[DataParallel], d_real: torch.Tensor,
                  d_fake: torch.Tensor) -> torch.Tensor:
    """log(Z + 1e-8), Z = sum(exp(-d_real)) + sum(exp(-d_fake)) over the
    global batch: each rank's energies gathered (``gather_rows``,
    differentiable); over ``d_real`` and ``d_fake`` themselves without
    ``dp``."""
    return _log(torch.sum(torch.exp(-gather_rows(dp, d_real)))
                + torch.sum(torch.exp(-gather_rows(dp, d_fake))))


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, z=None) -> (state, out)``: both
    updates from one forward. ``z`` (B, latent_dim) is drawn from
    ``state.draws`` unless passed in. ``out`` holds ``d_loss``, ``g_loss``
    and ``gen_imgs`` (NCHW). Under data parallelism (``state.dp``) z is the
    global batch's, drawn or passed in, and the step keeps this rank's
    rows; the partition is the global batch's and the losses in ``out``
    global means. No host sync: ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params, d_params = list(G.parameters()), list(D.parameters())

    def step(state: TrainState, imgs_u8, labels=None, z=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        b, dp = real.shape[0], state.dp
        if z is None:
            z = torch.randn(global_batch(dp, b), cfg.latent_dim, generator=state.draws,
                            device=device)
        z = local_rows(dp, z)

        gen = G(z)
        d_real, d_fake = D(real).float(), D(gen).float()
        part = log_partition(dp, d_real, d_fake)
        d_loss = (1.0 / b) * torch.sum(d_real) + part
        g_loss = (1.0 / (2 * b)) * (torch.sum(d_real) + torch.sum(d_fake)) + part
        d_grads = torch.autograd.grad(d_loss, d_params, retain_graph=True)
        g_grads = torch.autograd.grad(d_loss + g_loss, g_params)
        for params, grads, opt in ((d_params, d_grads, opt_d), (g_params, g_grads, opt_g)):
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "gen_imgs": gen.detach()}
        return state, global_means(dp, out, ("d_loss", "g_loss"))

    return step


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__], device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
