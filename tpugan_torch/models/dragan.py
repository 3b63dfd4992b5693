"""DRAGAN (Kodali et al. 2017): the port of ``tpugan/models/dragan.py``.

DCGAN's networks and data at 32px (dragan.py:45-100, ``weights_init_normal``),
BCE, G then D with Adam(2e-4, 0.5, 0.999) (dragan.py:184-217), and a
gradient penalty on perturbed real data with lambda 10 (dragan.py:142-167;
``ops.penalty.dragan_penalty``: element-wise alpha and noise, the population
std, the norm over the channel axis at every position).

The reference's latent bugs, as the JAX package treats them: the loop runs
over the real loader (dragan.py:175 names an undefined one); D minimizes
d_loss + lambda * penalty, or with ``--reference_quirks`` the penalty alone,
as the reference's lone ``gradient_penalty.backward()`` does
(dragan.py:209-217); ``d_loss`` is reported either way. Samples are per
epoch: the last logged batch's fakes, all of them, ``sqrt(batch_size)`` a
row, to ``images/<epoch>.png`` (dragan.py:224).

BatchNorm: D's running statistics take three updates a step, from the G
phase's forward and the D phase's forwards on the real batch and the fakes;
the penalty's forward normalizes by its batch statistics but leaves the
running ones alone (``batch_stats_frozen``), as the JAX package throws its
update away (``tpugan/models/dragan.py:99-112``). No kernel of the port runs
here.

Under data parallelism the penalty's std is the global batch's
(``parallel.mesh.global_std``), alpha and noise are drawn at the global
batch's shape and cut to the rank's rows, and the step's ``gen_imgs`` are
gathered from the ranks, so rank 0, which alone logs, keeps the whole
batch's fakes for its epoch's grid.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import torch

from tpugan_torch.losses import bce
from tpugan_torch.models import dcgan as _dcgan
from tpugan_torch.models._common import run_mnist_recipe, save_grid, std_log_line
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.nn.layers import batch_stats_frozen
from tpugan_torch.ops.penalty import dragan_penalty
from tpugan_torch.parallel.mesh import gather_rows, global_batch, global_means, local_rows
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import config_from_args, flag

NAME = "dragan"
LAMBDA_GP = 10.0  # dragan.py:107


@dataclasses.dataclass
class Config(_dcgan.Config):
    # Flag parity with dragan.py:21-33 (dcgan's set) and tpugan.models.dragan.
    reference_quirks: bool = flag(
        False, "reproduce the reference's penalty-only D update (latent bug)"
    )


def build(cfg: Config, device) -> dict:
    return _dcgan.build(cfg, device)


create_state = create_state_b
make_loader = _dcgan.make_loader


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, z=None, masks=None, alpha=None,
    noise=None) -> (state, out)``: one G update, then one D update.

    Draws, from ``state.draws`` in this order unless passed in: ``z`` (B,
    latent_dim); ``masks``, the Dropout2d keep masks of D's four forwards
    (G phase, real, fakes, penalty), each a list from ``D.draw_masks``;
    ``alpha`` and ``noise``, the penalty's, each of the real batch's shape
    (NCHW). ``out`` holds ``d_loss`` (the BCE part), ``g_loss`` and
    ``gen_imgs``. Under data parallelism (``state.dp``) every draw is the
    global batch's, drawn or passed in, the step keeps this rank's rows,
    the losses are global means and ``gen_imgs`` the global batch's. No
    host sync: ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params, d_params = list(G.parameters()), list(D.parameters())

    def step(state: TrainState, imgs_u8, labels=None, z=None, masks=None, alpha=None,
             noise=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        dp = state.dp
        b = global_batch(dp, real.shape[0])
        shape = (b, *real.shape[1:])
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) for _ in range(4)]
        if alpha is None:
            alpha = torch.rand(shape, generator=state.draws, device=device)
        if noise is None:
            noise = torch.rand(shape, generator=state.draws, device=device)
        z, alpha, noise = (local_rows(dp, x) for x in (z, alpha, noise))
        masks = [[local_rows(dp, m) for m in ms] for ms in masks]

        # G phase (dragan.py:184-200): only G's parameters take gradients.
        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        g_loss = bce(D(gen, masks[0]), 1.0)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase (dragan.py:202-217) on the real batch, the fakes detached,
        # and the penalty's forward with its own masks.
        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        d_loss = 0.5 * (bce(D(real, masks[1]), 1.0) + bce(D(fake, masks[2]), 0.0))
        with batch_stats_frozen(D):
            gp = LAMBDA_GP * dragan_penalty(lambda x: D(x, masks[3]), real, alpha, noise, dp=dp)
        (gp if cfg.reference_quirks else d_loss + gp).backward(inputs=d_params)
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
               "gen_imgs": gather_rows(dp, fake)}
        return state, global_means(dp, out, ("d_loss", "g_loss"))

    return step


def run(cfg: Config, device=None):
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    last = {"gen": None}
    std_log = std_log_line(cfg)

    def log(epoch, i, bpe, out):
        # A fused dispatch's images are the graph's output, which the next
        # replay overwrites: keep a copy.
        last["gen"] = out["gen_imgs"].clone()
        std_log(epoch, i, bpe, out)

    def epoch_end(state, epoch):
        if last["gen"] is not None:
            save_grid(last["gen"], os.path.join(imgdir, "%d.png" % epoch),
                      int(math.sqrt(cfg.batch_size)))
        return state

    return run_mnist_recipe(cfg, sys.modules[__name__],
                            Callbacks(log=log, epoch_end=epoch_end), device=device)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
