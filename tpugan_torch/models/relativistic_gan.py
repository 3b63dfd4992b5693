"""Relativistic GAN (Jolicoeur-Martineau 2018): the port of
``tpugan/models/relativistic_gan.py``.

DCGAN's networks and data at 32px with torch's own init on both (no
``weights_init_normal``: kaiming-uniform convs, BatchNorm at scale 1, bias
0) and no Sigmoid on D (relativistic_gan.py:58-91), BCEWithLogits on the
relativistic differences, G then D with Adam(2e-4, 0.5, 0.999)
(relativistic_gan.py:140-182). The standard RSGAN compares D(x) with
D(G(z)) sample by sample; ``--rel_avg_gan`` (RaGAN) compares each with the
batch mean of the other.

The reference computes the relativistic G loss and then overwrites it with
plain BCEWithLogits(D(G(z)), 1) (relativistic_gan.py:151-157). The default,
as the JAX package's, trains on the relativistic loss;
``--reference_quirks`` on the overwritten one.

D runs four times a step, each forward with its own Dropout2d masks and a
BatchNorm update: in the G phase on the real batch first (its output
detached) and then on the fakes; in the D phase on the real batch and on
the fakes detached. No kernel of the port runs here.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch

from tpugan_torch.losses import bce_with_logits
from tpugan_torch.models import dcgan as _dcgan
from tpugan_torch.models._common import run_mnist_recipe
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.parallel.mesh import (
    DataParallel,
    gather_rows,
    global_batch,
    global_means,
    local_rows,
)
from tpugan_torch.nn.blocks import DCGANDiscriminator, DCGANGenerator
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import config_from_args, flag

NAME = "relativistic_gan"


@dataclasses.dataclass
class Config(_dcgan.Config):
    # Flag parity with relativistic_gan.py:20-31 and tpugan.models.relativistic_gan.
    rel_avg_gan: bool = flag(False, "relativistic average GAN instead of standard")
    reference_quirks: bool = flag(
        False, "reproduce the reference's g_loss overwrite (plain BCE G update)"
    )


def build(cfg: Config, device) -> dict:
    """G and D in torch's init, drawn from a generator seeded by ``--seed``
    on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": DCGANGenerator(cfg.img_size, cfg.channels, cfg.latent_dim,
                                    init_mode="torch", generator=gen),
        "discriminator": DCGANDiscriminator(cfg.img_size, cfg.channels, sigmoid=False,
                                            init_mode="torch", generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = _dcgan.make_loader


def _centered(pred: torch.Tensor, other: torch.Tensor, average: bool,
              dp: Optional[DataParallel] = None) -> torch.Tensor:
    """``pred - other`` (RSGAN), or ``pred - mean(other)`` over the batch
    (RaGAN): the global batch's under data parallelism (``dp``), ``other``
    gathered from the ranks (``gather_rows``, differentiable)."""
    pred, other = pred.float(), other.float()
    if not average:
        return pred - other
    return pred - torch.mean(gather_rows(dp, other), dim=0, keepdim=True)


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, z=None, masks=None) -> (state,
    out)``: one G update, then one D update.

    Draws, from ``state.draws`` in this order unless passed in: ``z`` (B,
    latent_dim); ``masks``, the Dropout2d keep masks of D's four forwards in
    call order (G phase real, G phase fakes, D phase real, D phase fakes),
    each a list from ``D.draw_masks``. ``out`` holds ``d_loss``, ``g_loss``
    and ``gen_imgs`` (NCHW). Under data parallelism (``state.dp``) the draws
    are the global batch's, drawn or passed in, the step keeps this rank's
    rows, RaGAN's means are the global batch's and the losses in ``out``
    global means. No host sync: ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())
    avg = cfg.rel_avg_gan

    def step(state: TrainState, imgs_u8, labels=None, z=None, masks=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        dp = state.dp
        b = global_batch(dp, real.shape[0])
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) for _ in range(4)]
        z = local_rows(dp, z)
        masks = [[local_rows(dp, m) for m in ms] for ms in masks]

        # G phase (relativistic_gan.py:140-160): only G's parameters take
        # gradients; D(real) runs first, its output detached.
        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        with torch.no_grad():
            real_pred = D(real, masks[0])
        fake_pred = D(gen, masks[1])
        if cfg.reference_quirks:
            g_loss = bce_with_logits(fake_pred, 1.0)
        else:
            g_loss = bce_with_logits(_centered(fake_pred, real_pred, avg, dp), 1.0)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase (relativistic_gan.py:166-182) on the real batch and the
        # pre-update fakes, detached.
        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        real_pred, fake_pred = D(real, masks[2]), D(fake, masks[3])
        d_loss = (bce_with_logits(_centered(real_pred, fake_pred, avg, dp), 1.0)
                  + bce_with_logits(_centered(fake_pred, real_pred, avg, dp), 0.0)) / 2
        d_loss.backward()
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "gen_imgs": fake}
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
