"""ACGAN (Odena et al. 2017), the auxiliary-classifier GAN: the port of
``tpugan/models/acgan.py``.

Template-B generator on Embedding(n_classes, latent_dim)(labels) * z
(acgan.py:50,70); template-B discriminator trunk with two heads, adv
(Sigmoid) and aux (Softmax) (acgan.py:74-100); BCE plus cross-entropy on the
real and the fake batch (acgan.py:112-113,175-207), with the reference's
double softmax kept (``losses.cross_entropy_on_softmax``); the classifier's
accuracy on both batches as ``d_acc`` (acgan.py:208-220), a 0-d device
tensor until the host reads a row. ``weights_init_normal`` on both
networks. Samples: cgan's class grid. No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import bce, cross_entropy_on_softmax
from tpugan_torch.models import cgan as _cgan
from tpugan_torch.models._common import acc_log_line, mnist_loader, run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.nn.blocks import DCGANAuxDiscriminator, DCGANGenerator
from tpugan_torch.nn.layers import Embedding
from tpugan_torch.parallel.mesh import global_batch, global_means, local_rows
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import config_from_args

NAME = "acgan"


@dataclasses.dataclass
class Config(_cgan.Config):
    # Flag parity with acgan.py:23-33 (cgan's set).
    pass


class ACGANGenerator(nn.Module):
    """``label_emb``, then DCGAN's ``l1`` and ``conv_blocks`` on
    emb(labels) * z (acgan.py:47-72)."""

    def __init__(self, img_size: int, channels: int, latent_dim: int, n_classes: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.label_emb = Embedding(n_classes, latent_dim, generator=generator)
        body = DCGANGenerator(img_size, channels, latent_dim, generator=generator)
        self.init_size, self.l1, self.conv_blocks = body.init_size, body.l1, body.conv_blocks

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return DCGANGenerator.forward(self, self.label_emb(labels) * z)


class ACGANDiscriminator(DCGANAuxDiscriminator):
    """``conv_blocks``, ``adv_layer`` (Linear, Sigmoid) and ``aux_layer``
    (Linear to n_classes, Softmax); returns (validity, label)."""

    def __init__(self, img_size: int, channels: int, n_classes: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(img_size, channels, [("adv_layer", 1, [nn.Sigmoid()]),
                                              ("aux_layer", n_classes, [nn.Softmax(dim=-1)])],
                         generator=generator)


def build(cfg: Config, device) -> dict:
    """G and D with weights drawn from a generator seeded by ``--seed`` (on
    the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": ACGANGenerator(cfg.img_size, cfg.channels, cfg.latent_dim, cfg.n_classes,
                                    generator=gen),
        "discriminator": ACGANDiscriminator(cfg.img_size, cfg.channels, cfg.n_classes,
                                            generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = mnist_loader


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The share of rows whose largest probability is at the label, a 0-d
    tensor on the device (acgan.py:217-220)."""
    return (probs.argmax(dim=1) == labels).float().mean()


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels, z=None, gen_labels=None, masks=None)
    -> (state, out)``: one G update, then one D update
    (``tpugan/models/acgan.py:97-182``).

    Draws, from ``state.draws`` in this order unless passed in: ``z`` (B,
    latent_dim), ``gen_labels`` (B,) uniform over the classes, and
    ``masks``, the Dropout2d keep masks of D's three forwards (G phase,
    real, fakes). ``out`` holds ``d_loss``, ``g_loss``, ``d_acc`` and
    ``gen_imgs``. Under data parallelism (``state.dp``) the draws are the
    global batch's, drawn or passed in, the step keeps this rank's rows and
    the scalars in ``out`` are global means (``d_acc`` a mean over each
    rank's equal share of rows, ``tpugan/models/acgan.py:155``). No host
    sync: ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs_u8, labels, z=None, gen_labels=None, masks=None):
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        labels = labels.to(device, non_blocking=True).long()
        dp = state.dp
        b = global_batch(dp, real.shape[0])
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if gen_labels is None:
            gen_labels = torch.randint(0, cfg.n_classes, (b,), generator=state.draws,
                                       device=device)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) for _ in range(3)]
        z, gen_labels = local_rows(dp, z), local_rows(dp, gen_labels)
        masks = [[local_rows(dp, m) for m in ms] for ms in masks]

        opt_g.zero_grad(set_to_none=True)
        gen = G(z, gen_labels)
        validity, pred_label = D(gen, masks[0])
        g_loss = 0.5 * (bce(validity, 1.0) + cross_entropy_on_softmax(pred_label, gen_labels))
        g_loss.backward(inputs=g_params)
        opt_g.step()

        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        real_pred, real_aux = D(real, masks[1])
        fake_pred, fake_aux = D(fake, masks[2])
        d_real = 0.5 * (bce(real_pred, 1.0) + cross_entropy_on_softmax(real_aux, labels))
        d_fake = 0.5 * (bce(fake_pred, 0.0) + cross_entropy_on_softmax(fake_aux, gen_labels))
        d_loss = 0.5 * (d_real + d_fake)
        d_loss.backward()
        opt_d.step()
        d_acc = accuracy(torch.cat([real_aux, fake_aux]).detach(),
                         torch.cat([labels, gen_labels]))

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "d_acc": d_acc,
               "gen_imgs": fake}
        return state, global_means(dp, out, ("d_loss", "g_loss", "d_acc"))

    return step


make_sampler = _cgan.make_sampler


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    return run_mnist_recipe(cfg, sys.modules[__name__],
                            Callbacks(log=acc_log_line(cfg), sample=make_sampler(cfg)),
                            device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
