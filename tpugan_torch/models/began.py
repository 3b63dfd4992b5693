"""Boundary Equilibrium GAN (Berthelot et al. 2017): the port of
``tpugan/models/began.py``.

DCGAN's generator with its first BatchNorm at latent 62 (began.py:47-72)
and an autoencoder discriminator (began.py:75-99), MNIST at 32px,
Adam(2e-4, 0.5, 0.999), G then D. ``weights_init_normal`` reaches the convs
only, so the BatchNorm1d layers keep torch's init (began.py:38-44).

L1 reconstruction energies (began.py:154-196): G minimizes mean|D(G(z)) -
G(z)| with the gradient through both terms (the target is not detached,
began.py:163); D minimizes L_real - k * L_fake on the fakes detached. The
equilibrium term k is carried from step to step, k <- clip(k + 0.001 *
(0.75 * L_real - L_fake), 0, 1) from 0 (began.py:139-193): a 0-d device
tensor in ``state.aux["k"]`` that the step updates in place, so a captured
CUDA graph carries it from replay to replay. The log line adds the
convergence measure M = L_real + |0.75 * L_real - L_fake| and k
(began.py:196-205). z is the step's only draw. No kernel of the port runs
here.

Under data parallelism the equilibrium update reads the global batch's
L_real and L_fake (``tpugan/models/began.py:151-165`` over a sharded batch),
one all-reduce with the reported losses, so k stays equal on every rank;
each rank's D loss uses its own means, whose gradients the optimizer hook
averages into the global loss's.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch
from torch import nn

from tpugan_torch.models import dcgan as _dcgan
from tpugan_torch.models._common import grid_sampler, run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.models.ebgan import Config as _EBGANConfig
from tpugan_torch.models.ebgan import autoencoder_down_up
from tpugan_torch.nn.blocks import DCGANGenerator
from tpugan_torch.nn.layers import BatchNorm1d, Linear
from tpugan_torch.parallel.mesh import global_batch, global_mean, local_rows
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import config_from_args

NAME = "began"
GAMMA = 0.75  # began.py:140
LAMBDA_K = 0.001  # began.py:141


@dataclasses.dataclass
class Config(_EBGANConfig):
    """Flag parity with began.py:19-30 (ebgan's set) and tpugan.models.began."""


class BEGANDiscriminator(nn.Module):
    """began.py:75-99: ``down``, ``fc`` = [Linear(64 * (s/2)^2 -> 32),
    BatchNorm1d(32, eps=0.8), ReLU, Linear(32 -> 64 * (s/2)^2), BatchNorm1d,
    ReLU], ``up``; ``forward`` returns the reconstruction."""

    def __init__(self, img_size: int, channels: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down_size = img_size // 2
        down_dim = 64 * self.down_size ** 2
        self.down, up = autoencoder_down_up(channels, generator)
        self.fc = nn.Sequential(Linear(down_dim, 32, generator=generator), BatchNorm1d(32, 0.8),
                                nn.ReLU(), Linear(32, down_dim, generator=generator),
                                BatchNorm1d(down_dim), nn.ReLU())
        self.up = up

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        out = self.down(img)
        out = self.fc(out.reshape(out.shape[0], -1))
        return self.up(out.view(out.shape[0], 64, self.down_size, self.down_size))


def build(cfg: Config, device) -> dict:
    """G and D drawn from a generator seeded by ``--seed`` on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": DCGANGenerator(cfg.img_size, cfg.channels, cfg.latent_dim, generator=gen),
        "discriminator": BEGANDiscriminator(cfg.img_size, cfg.channels, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Template B's state, with k = 0 (began.py:142) in ``aux``."""
    state = create_state_b(cfg, modules, device)
    state.aux["k"] = torch.zeros((), device=device)
    return state


make_loader = _dcgan.make_loader


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, z=None) -> (state, out)``: one G
    update, one D update and the equilibrium update of ``state.aux["k"]``,
    in place. ``z`` (B, latent_dim) is drawn from ``state.draws`` unless
    passed in. ``out`` holds ``d_loss``, ``g_loss``, ``M``, ``k`` (the
    updated value, a tensor of its own) and ``gen_imgs`` (NCHW). Under data
    parallelism (``state.dp``) z is the global batch's, drawn or passed in,
    the step keeps this rank's rows, and k, M and the losses come from the
    global means. No host sync: ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs_u8, labels=None, z=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        dp = state.dp
        if z is None:
            z = torch.randn(global_batch(dp, real.shape[0]), cfg.latent_dim,
                            generator=state.draws, device=device)
        z = local_rows(dp, z)
        k = state.aux["k"]

        # G phase (began.py:154-166): the L1 target is G(z) itself, not
        # detached.
        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        g_loss = torch.mean(torch.abs(D(gen).float() - gen.float()))
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase (began.py:172-183) on the real batch and the pre-update
        # fakes, detached.
        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        loss_real = torch.mean(torch.abs(D(real).float() - real))
        loss_fake = torch.mean(torch.abs(D(fake).float() - fake.float()))
        d_loss = loss_real - k * loss_fake
        d_loss.backward()
        opt_d.step()

        # The equilibrium update (began.py:189-196), on the global means.
        with torch.no_grad():
            means = global_mean(dp, torch.stack([loss_real, loss_fake, d_loss, g_loss]))
            loss_real, loss_fake, d_loss, g_loss = means.unbind()
            diff = GAMMA * loss_real - loss_fake
            k_new = torch.clamp(k + LAMBDA_K * diff, 0.0, 1.0)
            m = loss_real + torch.abs(diff)
            k.copy_(k_new)

        state.step += 1
        return state, {"d_loss": d_loss, "g_loss": g_loss, "M": m, "k": k_new,
                       "gen_imgs": fake}

    return step


def log_line(cfg: Config):
    """began.py:202-205: the reference's line with M and k."""

    def log(epoch, i, bpe, out):
        print("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f] -- M: %f, k: %f"
              % (epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]), float(out["g_loss"]),
                 float(out["M"]), float(out["k"])))

    return log


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__],
                            Callbacks(log=log_line(cfg), sample=grid_sampler(cfg)), device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
