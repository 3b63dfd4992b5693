"""InfoGAN (Chen et al. 2016): the port of ``tpugan/models/infogan.py``.

DCGAN's generator on [z (62), one-hot label (10), code (2)]
(infogan.py:61,80-85); template-B discriminator trunk with three heads: adv
(raw Linear), class (Softmax) and the continuous code (infogan.py:110-121).
Three phases a batch (infogan.py:203-282): G (MSE adversarial), D (MSE
adversarial), then the information phase on fresh z, labels and code,
lambda_cat * CE + lambda_con * MSE, through the updated G and D and a third
Adam over the parameters of both, with moments of its own
(infogan.py:164-168; the duplicated-moment quirk kept). The reference's
double softmax is kept. The adversarial phases ignore the true labels.
Samples, three grids an interval: ``static`` (noise, the class grid, zero
code), ``varying_c1`` and ``varying_c2`` (zero noise, one code swept over
[-1, 1] down the rows) (infogan.py:173-196). No kernel of the port runs
here.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from tpugan_torch.losses import cross_entropy_on_softmax, mse
from tpugan_torch.models._common import mnist_loader, run_mnist_recipe, sample_noise, save_grid
from tpugan_torch.models.cgan import class_grid
from tpugan_torch.nn.blocks import DCGANAuxDiscriminator, DCGANGenerator
from tpugan_torch.nn.layers import batch_stats_frozen, rank_local
from tpugan_torch.parallel.mesh import global_batch, global_means, local_rows, rank_zero_write
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.optim import capturable
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "infogan"
LAMBDA_CAT, LAMBDA_CON = 1.0, 0.1  # infogan.py:129-131


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with infogan.py:24-35 and tpugan.models.infogan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(62, "dimensionality of the latent space")
    code_dim: int = flag(2, "latent code")
    n_classes: int = flag(10, "number of classes for dataset")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "interval between image sampling")


def to_categorical(labels: torch.Tensor, num_columns: int) -> torch.Tensor:
    """One-hot float rows (infogan.py:50-55), built by comparison with the
    column count given: ``F.one_hot`` without it reads the largest label on
    the host, which a CUDA graph cannot capture."""
    return (labels[:, None] == torch.arange(num_columns, device=labels.device)).float()


class InfoGANGenerator(DCGANGenerator):
    """DCGAN's ``l1`` and ``conv_blocks`` on [z, label one-hot, code]: its
    ``latent_dim`` is their width, latent_dim + n_classes + code_dim."""

    def forward(self, z: torch.Tensor, labels_onehot: torch.Tensor,
                code: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([z, labels_onehot, code], dim=-1))


class InfoGANDiscriminator(DCGANAuxDiscriminator):
    """``conv_blocks``, ``adv_layer`` (Linear), ``aux_layer`` (Linear to
    n_classes, Softmax) and ``latent_layer`` (Linear to code_dim); returns
    (validity, label, code)."""

    def __init__(self, img_size: int, channels: int, n_classes: int, code_dim: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(img_size, channels,
                         [("adv_layer", 1, []), ("aux_layer", n_classes, [nn.Softmax(dim=-1)]),
                          ("latent_layer", code_dim, [])],
                         generator=generator)


def build(cfg: Config, device) -> dict:
    """G and D with weights drawn from a generator seeded by ``--seed`` (on
    the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": InfoGANGenerator(cfg.img_size, cfg.channels,
                                      cfg.latent_dim + cfg.n_classes + cfg.code_dim,
                                      generator=gen),
        "discriminator": InfoGANDiscriminator(cfg.img_size, cfg.channels, cfg.n_classes,
                                              cfg.code_dim, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) for G, for D, and ``info`` over the parameters of
    both with its own moments, all capturable on CUDA; a device generator of
    the draws seeded by ``--seed``."""
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                           **capturable(device))
    G, D = modules["generator"], modules["discriminator"]
    optimizers = {"generator": adam(G.parameters()), "discriminator": adam(D.parameters()),
                  "info": adam(list(G.parameters()) + list(D.parameters()))}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, optimizers, draws)


make_loader = mnist_loader


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, z=None, gen_labels=None,
    code=None, info_z=None, info_labels=None, info_code=None, masks=None)
    -> (state, out)``: the G, D and information updates
    (``tpugan/models/infogan.py:119-228``).

    Draws, from ``state.draws`` in this order unless passed in: the G
    phase's ``z`` (B, latent_dim), ``gen_labels`` (B,) uniform over the
    classes and ``code`` (B, code_dim) U[-1, 1); the information phase's
    ``info_z``, ``info_labels`` and ``info_code`` alike; then ``masks``, the
    Dropout2d keep masks of D's four forwards (G phase, real, fakes,
    information phase). ``out`` holds ``d_loss``, ``g_loss``, ``info_loss``
    and ``gen_imgs``. Under data parallelism (``state.dp``) every draw is
    the global batch's, drawn or passed in, the step keeps this rank's rows
    and the losses in ``out`` are global means. No host sync:
    ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    opt_info = state.optimizers["info"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs_u8, labels=None, z=None, gen_labels=None, code=None,
             info_z=None, info_labels=None, info_code=None, masks=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        dp = state.dp
        b = global_batch(dp, real.shape[0])

        def draw(z, labels, code):
            if z is None:
                z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
            if labels is None:
                labels = torch.randint(0, cfg.n_classes, (b,), generator=state.draws,
                                       device=device)
            if code is None:
                code = torch.rand(b, cfg.code_dim, generator=state.draws, device=device) * 2 - 1
            return z, labels, code

        z, gen_labels, code = draw(z, gen_labels, code)
        info_z, info_labels, info_code = draw(info_z, info_labels, info_code)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) for _ in range(4)]
        z, gen_labels, code, info_z, info_labels, info_code = (
            local_rows(dp, x) for x in (z, gen_labels, code, info_z, info_labels, info_code))
        masks = [[local_rows(dp, m) for m in ms] for ms in masks]

        opt_g.zero_grad(set_to_none=True)
        gen = G(z, to_categorical(gen_labels, cfg.n_classes), code)
        g_loss = mse(D(gen, masks[0])[0], 1.0)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        d_loss = 0.5 * (mse(D(real, masks[1])[0], 1.0) + mse(D(fake, masks[2])[0], 0.0))
        d_loss.backward()
        opt_d.step()

        # Information phase through the updated G and D.
        opt_info.zero_grad(set_to_none=True)
        gen2 = G(info_z, to_categorical(info_labels, cfg.n_classes), info_code)
        _, pred_label, pred_code = D(gen2, masks[3])
        info_loss = (LAMBDA_CAT * cross_entropy_on_softmax(pred_label, info_labels)
                     + LAMBDA_CON * mse(pred_code, info_code))
        info_loss.backward()
        opt_info.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
               "info_loss": info_loss.detach(), "gen_imgs": fake}
        return state, global_means(dp, out, ("d_loss", "g_loss", "info_loss"))

    return step


SAMPLE_DIRS = ("static", "varying_c1", "varying_c2")


def make_sampler(cfg: Config):
    """``sample(state, out, batches_done)``: three grids of n_classes^2
    images, n_classes a row, to ``images/<dir>/<batches_done>.png`` for each
    of ``SAMPLE_DIRS``; G in training mode, its running statistics left as
    they were, the noise from ``_common.sample_noise`` (``state.draws``
    stays as it was). Under data parallelism rank 0 alone samples, its
    BatchNorm on the sample batch alone (``rank_local``)."""
    n_row = cfg.n_classes
    n = n_row * n_row
    dirs = {d: os.path.join(cfg.output_dir, "images", d) for d in SAMPLE_DIRS}
    for path in dirs.values():
        os.makedirs(path, exist_ok=True)
    varied = np.repeat(np.linspace(-1, 1, n_row)[:, None], n_row, 0)
    zeros = np.zeros((n, 1))
    codes = {"static": np.zeros((n, cfg.code_dim)),
             "varying_c1": np.concatenate([varied, zeros], -1),
             "varying_c2": np.concatenate([zeros, varied], -1)}

    @torch.no_grad()
    def write(state, batches_done):
        G = state.modules["generator"]
        device = state.draws.device
        labels = to_categorical(class_grid(n_row, device), cfg.n_classes)
        noise = {"static": sample_noise(cfg, batches_done, (n, cfg.latent_dim), device)}
        for d in SAMPLE_DIRS:
            z = noise.get(d, torch.zeros(n, cfg.latent_dim, device=device))
            code = torch.tensor(codes[d], dtype=torch.float32, device=device)
            with rank_local(G), batch_stats_frozen(G):
                imgs = G(z, labels, code)
            save_grid(imgs, os.path.join(dirs[d], "%d.png" % batches_done), n_row)

    def sample(state, out, batches_done):
        rank_zero_write(lambda: write(state, batches_done))

    return sample


def log_line(cfg):
    """``tpugan/models/infogan.py:283-291``: the std line with ``[info loss: f]``."""

    def log(epoch, i, bpe, out):
        print(
            "[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f] [info loss: %f]"
            % (epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]), float(out["g_loss"]),
               float(out["info_loss"]))
        )

    return log


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__],
                            Callbacks(log=log_line(cfg), sample=make_sampler(cfg)),
                            device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
