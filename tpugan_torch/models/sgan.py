"""SGAN (Odena 2016), the semi-supervised GAN: the port of
``tpugan/models/sgan.py``.

DCGAN's generator on plain z (sgan.py:48-73); template-B discriminator
trunk with an adv head (Sigmoid) and a (num_classes + 1)-way aux head
(Softmax), the extra class ``num_classes`` marking a fake (sgan.py:98-99,
162). G: BCE only (sgan.py:185); D: (BCE + CE)/2 on the real batch with its
labels and on the fakes with the fake class, halved again (sgan.py:193-202),
with the reference's double softmax kept; the classifier's accuracy as
``d_acc``, a 0-d device tensor until the host reads a row, in the row and
in the log line. Note the flag ``--num_classes``, not ``--n_classes``. The
5x5 sample grid of the step's fakes (sgan.py:219-220). No kernel of the port
runs here.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import bce, cross_entropy_on_softmax
from tpugan_torch.models._common import (
    acc_log_line,
    grid_sampler,
    mnist_loader,
    run_mnist_recipe,
)
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.models.acgan import accuracy
from tpugan_torch.nn.blocks import DCGANAuxDiscriminator, DCGANGenerator
from tpugan_torch.parallel.mesh import global_batch, global_means, local_rows
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "sgan"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with sgan.py:20-31 and tpugan.models.sgan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    num_classes: int = flag(10, "number of classes for dataset")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "interval between image sampling")


class SGANDiscriminator(DCGANAuxDiscriminator):
    """``conv_blocks``, ``adv_layer`` (Linear, Sigmoid) and ``aux_layer``
    (Linear to num_classes + 1, Softmax); returns (validity, label)."""

    def __init__(self, img_size: int, channels: int, num_classes: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(img_size, channels,
                         [("adv_layer", 1, [nn.Sigmoid()]),
                          ("aux_layer", num_classes + 1, [nn.Softmax(dim=-1)])],
                         generator=generator)


def build(cfg: Config, device) -> dict:
    """G and D with weights drawn from a generator seeded by ``--seed`` (on
    the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": DCGANGenerator(cfg.img_size, cfg.channels, cfg.latent_dim, generator=gen),
        "discriminator": SGANDiscriminator(cfg.img_size, cfg.channels, cfg.num_classes,
                                           generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = mnist_loader


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels, z=None, masks=None) -> (state, out)``:
    one G update, then one D update (``tpugan/models/sgan.py:93-170``).

    Draws, from ``state.draws`` in this order unless passed in: ``z`` (B,
    latent_dim) and ``masks``, the Dropout2d keep masks of D's three
    forwards (G phase, real, fakes). ``out`` holds ``d_loss``, ``g_loss``,
    ``d_acc`` and ``gen_imgs``. Under data parallelism (``state.dp``) the
    draws are the global batch's, drawn or passed in, the step keeps this
    rank's rows and the scalars in ``out`` are global means. No host sync:
    ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs_u8, labels, z=None, masks=None):
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        labels = labels.to(device, non_blocking=True).long()
        dp = state.dp
        b = global_batch(dp, real.shape[0])
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) for _ in range(3)]
        z = local_rows(dp, z)
        masks = [[local_rows(dp, m) for m in ms] for ms in masks]
        fake_aux_gt = torch.full((real.shape[0],), cfg.num_classes, dtype=torch.long,
                                 device=device)

        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        validity, _ = D(gen, masks[0])
        g_loss = bce(validity, 1.0)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        real_pred, real_aux = D(real, masks[1])
        fake_pred, fake_aux = D(fake, masks[2])
        d_real = 0.5 * (bce(real_pred, 1.0) + cross_entropy_on_softmax(real_aux, labels))
        d_fake = 0.5 * (bce(fake_pred, 0.0) + cross_entropy_on_softmax(fake_aux, fake_aux_gt))
        d_loss = 0.5 * (d_real + d_fake)
        d_loss.backward()
        opt_d.step()
        d_acc = accuracy(torch.cat([real_aux, fake_aux]).detach(),
                         torch.cat([labels, fake_aux_gt]))

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "d_acc": d_acc,
               "gen_imgs": fake}
        return state, global_means(dp, out, ("d_loss", "g_loss", "d_acc"))

    return step


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__],
                            Callbacks(log=acc_log_line(cfg), sample=grid_sampler(cfg)),
                            device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
