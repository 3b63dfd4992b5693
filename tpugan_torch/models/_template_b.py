"""Template-B (DCGAN-style) 1:1 alternating step (``tpugan/models/_template_b.py``),
shared by dcgan (BCE, dcgan/dcgan.py:143-183), lsgan (MSE,
lsgan/lsgan.py:140-188), gan (template A's MLPs, BCE, gan/gan.py:135-161,
whose discriminator draws no masks) and bgan (gan's, with the
boundary-seeking G loss, bgan/bgan.py:139-165).

G update first on a fresh fake batch, then D update on the real batch and
the same fakes detached, both Adam. The discriminator's BatchNorm running
statistics advance through its three forwards in the reference's order (G
phase on the fakes, D phase on the real batch, then on the fakes), and each
forward gets its own Dropout2d masks.

Random draws (z, then the three forwards' Dropout2d masks) come from the
state's device generator or are passed in, so a test can hand both
frameworks the same numbers. The step makes no host sync, allocates no host
memory and reads no Python value that a CUDA graph would freeze, so
``graph_steps`` can capture it.

Under data parallelism (``state.dp``) the draws are the global batch's, as
one process draws them, and each rank keeps its rows; the losses in ``out``
are global means.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpugan_torch.parallel.mesh import global_batch, global_means, local_rows
from tpugan_torch.train.optim import capturable
from tpugan_torch.train.state import TrainState, normalize_uint8


def create_state_b(cfg, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) for G and for D, capturable on CUDA, and a device
    generator of the draws seeded by ``--seed``."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                      **capturable(device))
    optimizers = {k: adam(modules[k]) for k in ("generator", "discriminator")}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, optimizers, draws)


def make_step_b(cfg, state: TrainState, adv_loss: Callable,
                g_loss: Optional[Callable] = None):
    """``step(state, imgs_u8, labels=None, z=None, masks=None) -> (state,
    out)``: one G update, then one D update (``_template_b.py:make_step_b``).

    ``adv_loss(d_out, target)`` is the adversarial loss (bce for dcgan, mse
    for lsgan); ``g_loss(d_out)``, G's loss on D's output of the fakes, is
    ``adv_loss(d_out, 1.0)`` unless given (bgan's ``boundary_seeking``,
    ``tpugan/models/bgan.py:101-108``). ``imgs_u8`` is an NHWC uint8 batch.
    ``z`` is (B, latent_dim); ``masks`` holds the Dropout2d keep masks of
    D's three forwards, each a list from ``D.draw_masks``. Both are drawn
    from ``state.draws``, z first, unless passed in; a discriminator without
    ``draw_masks`` (template A's) takes none. Under data parallelism both
    are the global batch's, drawn or passed in, and the step keeps this
    rank's rows. ``out`` holds ``d_loss`` and ``g_loss`` (0-d tensors, global
    means) and ``gen_imgs``, the G phase's fakes (NCHW, this rank's)."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())
    uses_masks = hasattr(D, "draw_masks")
    g_adv = g_loss or (lambda d_out: adv_loss(d_out, 1.0))
    d = lambda x, m: D(x, m) if uses_masks else D(x)

    def step(state: TrainState, imgs_u8, labels=None, z=None, masks=None):
        del labels
        device, dp = state.draws.device, state.dp
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        b = global_batch(dp, real.shape[0])
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) if uses_masks else None for _ in range(3)]
        z = local_rows(dp, z)
        masks = [ms and [local_rows(dp, m) for m in ms] for ms in masks]

        # G phase: only G's parameters take gradients.
        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        g_loss = g_adv(d(gen, masks[0]))
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase on the real batch and the pre-update fakes, detached.
        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        d_loss = 0.5 * (adv_loss(d(real, masks[1]), 1.0) + adv_loss(d(fake, masks[2]), 0.0))
        d_loss.backward()
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "gen_imgs": fake}
        return state, global_means(dp, out, ("d_loss", "g_loss"))

    return step
