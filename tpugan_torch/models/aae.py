"""Adversarial Autoencoder (Makhzani et al. 2015): the port of
``tpugan/models/aae.py``.

An MLP encoder with the reparameterisation z = eps * exp(logvar / 2) + mu
(aae.py:39-67), an MLP decoder (aae.py:70-87) and a discriminator on the
10-dim codes (aae.py:90-105), MNIST at 32px. The encoder and the decoder
train under one Adam over both modules' parameters (aae.py:140-142) on
0.001 * BCE(D(E(x)), 1) + 0.999 * L1(Dec(E(x)), x) (aae.py:174-185); then D
on N(0, 1) codes as real and the encodings detached as fake (aae.py:191-202).
Draws, eps then the real codes, come from ``state.draws``. The sampler
decodes a 10x10 grid of N(0, 1) codes every ``--sample_interval`` batches
(aae.py:148-153). No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import sys
from typing import Optional, Tuple

import torch
from torch import nn

from tpugan_torch.losses import bce, l1
from tpugan_torch.models import gan as _gan
from tpugan_torch.models._common import run_mnist_recipe, sample_noise, save_grid, std_log_line
from tpugan_torch.nn.blocks import MLPDiscriminator
from tpugan_torch.nn.layers import BatchNorm1d, LeakyReLU, Linear, batch_stats_frozen, rank_local
from tpugan_torch.parallel.mesh import global_batch, global_means, local_rows, rank_zero_write
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.optim import capturable
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "aae"
N_ROW = 10  # the sample grid's, aae.py:150


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with aae.py:20-30 and tpugan.models.aae.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(10, "dimensionality of the latent code")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "interval between image sampling")


def _mlp_trunk(in_features: int, generator) -> list:
    """Linear -> 512, LeakyReLU(0.2), Linear 512 -> 512, BatchNorm1d (eps
    1e-5), LeakyReLU(0.2): the head of both aae.py:46-58 and :70-82."""
    return [Linear(in_features, 512, generator=generator), LeakyReLU(0.2),
            Linear(512, 512, generator=generator), BatchNorm1d(512), LeakyReLU(0.2)]


class Encoder(nn.Module):
    """aae.py:46-67: ``model`` on ``img.view(B, -1)``, then the heads ``mu``
    and ``logvar``; ``forward`` returns (mu, logvar): the reparameterisation
    draws, so the step does it."""

    def __init__(self, img_shape: Tuple[int, int, int], latent_dim: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(*_mlp_trunk(math.prod(img_shape), generator))
        self.mu = Linear(512, latent_dim, generator=generator)
        self.logvar = Linear(512, latent_dim, generator=generator)

    def forward(self, img: torch.Tensor):
        x = self.model(img.reshape(img.shape[0], -1))
        return self.mu(x), self.logvar(x)


class Decoder(nn.Module):
    """aae.py:70-87: ``model`` = the trunk, Linear(512 -> C*H*W), Tanh,
    viewed as (B, C, H, W)."""

    def __init__(self, img_shape: Tuple[int, int, int], latent_dim: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_shape = tuple(img_shape)  # (C, H, W)
        self.model = nn.Sequential(*_mlp_trunk(latent_dim, generator),
                                   Linear(512, math.prod(img_shape), generator=generator),
                                   nn.Tanh())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z).view(z.shape[0], *self.img_shape)


def build(cfg: Config, device) -> dict:
    """The encoder, decoder and latent discriminator (widths 512, 256, 1 and
    the Sigmoid), drawn from a generator seeded by ``--seed`` on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    img_shape = (cfg.channels, cfg.img_size, cfg.img_size)
    modules = {
        "encoder": Encoder(img_shape, cfg.latent_dim, generator=gen),
        "decoder": Decoder(img_shape, cfg.latent_dim, generator=gen),
        "discriminator": MLPDiscriminator(cfg.latent_dim, sigmoid=True, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) over the encoder's and then the decoder's
    parameters (``"g"``, itertools.chain as aae.py:140-142) and one for D,
    capturable on CUDA; the draws' generator seeded by ``--seed``."""
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                           **capturable(device))
    optimizers = {
        "g": adam(itertools.chain(modules["encoder"].parameters(),
                                  modules["decoder"].parameters())),
        "discriminator": adam(modules["discriminator"].parameters()),
    }
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, optimizers, draws)


make_loader = _gan.make_loader


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, eps=None, z=None) -> (state,
    out)``: one update of the encoder and decoder, then one of D. Draws, from
    ``state.draws`` in this order unless passed in: ``eps``, the
    reparameterisation's, and ``z``, D's real codes, each (B, latent_dim).
    ``out`` holds ``d_loss`` and ``g_loss``. Under data parallelism
    (``state.dp``) both draws are the global batch's, drawn or passed in,
    the step keeps this rank's rows and the losses are global means; the
    encoder's and decoder's BatchNorms take global statistics. No host
    sync: ``graph_steps`` can capture it."""
    E, Dec, D = (state.modules[k] for k in ("encoder", "decoder", "discriminator"))
    opt_g, opt_d = state.optimizers["g"], state.optimizers["discriminator"]
    g_params = list(E.parameters()) + list(Dec.parameters())

    def step(state: TrainState, imgs_u8, labels=None, eps=None, z=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        dp = state.dp
        shape = (global_batch(dp, real.shape[0]), cfg.latent_dim)
        if eps is None:
            eps = torch.randn(shape, generator=state.draws, device=device)
        if z is None:
            z = torch.randn(shape, generator=state.draws, device=device)
        eps, z = local_rows(dp, eps), local_rows(dp, z)

        # G phase (aae.py:174-185): the encoder and decoder together.
        opt_g.zero_grad(set_to_none=True)
        mu, logvar = E(real)
        encoded = eps * torch.exp(logvar / 2) + mu
        g_loss = 0.001 * bce(D(encoded), 1.0) + 0.999 * l1(Dec(encoded), real)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase (aae.py:191-202): N(0, 1) codes against the encodings.
        opt_d.zero_grad(set_to_none=True)
        d_loss = 0.5 * (bce(D(z), 1.0) + bce(D(encoded.detach()), 0.0))
        d_loss.backward()
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}
        return state, global_means(dp, out, ("d_loss", "g_loss"))

    return step


def make_sampler(cfg: Config):
    """``sample(state, out, batches_done)``: the decoder, in training mode
    as the reference leaves it, on a 10x10 grid of N(0, 1) codes from
    ``_common.sample_noise`` (a generator of its own: ``state.draws`` stays
    as it was), to ``images/<batches_done>.png``, 10 a row. The running
    statistics stay as they were (``batch_stats_frozen``): the JAX sampler
    drops its update (``tpugan/models/aae.py:196-200``). Under data
    parallelism rank 0 alone samples, the decoder's BatchNorm on the sample
    batch alone (``rank_local``)."""
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)

    @torch.no_grad()
    def write(state, batches_done):
        Dec = state.modules["decoder"]
        z = sample_noise(cfg, batches_done, (N_ROW * N_ROW, cfg.latent_dim), state.draws.device)
        with rank_local(Dec), batch_stats_frozen(Dec):
            imgs = Dec(z)
        save_grid(imgs, os.path.join(imgdir, "%d.png" % batches_done), N_ROW)

    def sample(state, out, batches_done):
        rank_zero_write(lambda: write(state, batches_done))

    return sample


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__],
                            Callbacks(log=std_log_line(cfg), sample=make_sampler(cfg)),
                            device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
