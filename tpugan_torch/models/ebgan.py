"""Energy-Based GAN (Zhao et al. 2016): the port of ``tpugan/models/ebgan.py``.

DCGAN's generator without its first BatchNorm at latent 62 (ebgan.py:47-71)
and an autoencoder discriminator that returns (reconstruction, embedding)
(ebgan.py:74-101), MNIST at 32px, Adam(2e-4, 0.5, 0.999), G then D.
``weights_init_normal`` matches the name "BatchNorm2d", so the
discriminator's BatchNorm1d layers keep torch's init (ebgan.py:38-44).

G minimizes MSE(D_recon(G(z)), G(z) detached) + 0.1 * pullaway(embedding);
D minimizes the reconstruction MSE of the real batch plus the hinge
max(0, margin - MSE of the fakes), margin = max(1, batch_size / 64)
(ebgan.py:156-202). The reference branches on the hinge on the host
(``.item()``); here it is a ``torch.clamp`` of the same value and, off the
kink at 0, the same gradient, so the step reads nothing back and a CUDA
graph can capture it. D has no dropout: z is the step's only draw. No
kernel of the port runs here.

Under data parallelism (``tpugan/models/ebgan.py:119,158-159`` over a
sharded batch) two terms couple samples, and each is the global batch's on
every rank: the pull-away term over the gathered embeddings
(``gather_rows``), and the hinge on the fakes' global MSE, the ranks' means
gathered (``mean_over_ranks``, differentiable), so every rank takes the
same side of the kink. ``margin`` reads ``--batch_size``, the global batch.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import mse, pullaway
from tpugan_torch.models import dcgan as _dcgan
from tpugan_torch.models._common import run_mnist_recipe
from tpugan_torch.parallel.mesh import (
    DataParallel,
    gather_rows,
    global_batch,
    global_means,
    local_rows,
    mean_over_ranks,
)
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.nn.blocks import DCGANGenerator
from tpugan_torch.nn.layers import BatchNorm1d, Conv2d, Linear, Upsample
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "ebgan"
LAMBDA_PT = 0.1  # ebgan.py:156


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with ebgan.py:19-30 and tpugan.models.ebgan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(62, "dimensionality of the latent space")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "number of image channels")


def autoencoder_down_up(channels: int, generator: Optional[torch.Generator]):
    """The ``down`` and ``up`` stacks the EBGAN and BEGAN discriminators
    share (ebgan.py:78-95, began.py:79-93): Conv(ch -> 64, 3, s2, p1) + ReLU;
    Upsample(2) + Conv(64 -> ch, 3, s1, p1); both convs ``normal02``."""
    down = nn.Sequential(Conv2d(channels, 64, 3, 2, 1, init_mode="normal02", generator=generator),
                         nn.ReLU())
    up = nn.Sequential(Upsample(2),
                       Conv2d(64, channels, 3, 1, 1, init_mode="normal02", generator=generator))
    return down, up


class EBGANDiscriminator(nn.Module):
    """ebgan.py:74-101: ``down``, ``embedding`` = Linear(64 * (s/2)^2 ->
    32), ``fc`` = [BatchNorm1d(32, eps=0.8), ReLU, Linear(32 -> 64 *
    (s/2)^2), BatchNorm1d, ReLU], ``up``; ``forward`` returns
    (reconstruction, embedding)."""

    def __init__(self, img_size: int, channels: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down_size = img_size // 2
        down_dim = 64 * self.down_size ** 2
        self.down, up = autoencoder_down_up(channels, generator)
        self.embedding = Linear(down_dim, 32, generator=generator)
        self.fc = nn.Sequential(BatchNorm1d(32, 0.8), nn.ReLU(),
                                Linear(32, down_dim, generator=generator), BatchNorm1d(down_dim),
                                nn.ReLU())
        self.up = up

    def forward(self, img: torch.Tensor):
        out = self.down(img)
        embedding = self.embedding(out.reshape(out.shape[0], -1))
        out = self.fc(embedding).view(out.shape[0], 64, self.down_size, self.down_size)
        return self.up(out), embedding


def build(cfg: Config, device) -> dict:
    """G and D drawn from a generator seeded by ``--seed`` on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": DCGANGenerator(cfg.img_size, cfg.channels, cfg.latent_dim, first_bn=False,
                                    generator=gen),
        "discriminator": EBGANDiscriminator(cfg.img_size, cfg.channels, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = _dcgan.make_loader


def fake_hinge(dp: Optional[DataParallel], fake_recon: torch.Tensor, fake: torch.Tensor,
               margin: float) -> torch.Tensor:
    """D's hinge on the fakes, max(0, margin - MSE(fake_recon, fake))
    (``tpugan/models/ebgan.py:158-159``), the MSE the global batch's: the
    ranks' means gathered (``mean_over_ranks``, differentiable), so every
    rank takes the same side of the kink."""
    return torch.clamp(margin - mean_over_ranks(dp, mse(fake_recon, fake)), min=0.0)


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels=None, z=None) -> (state, out)``: one G
    update, then one D update. ``z`` (B, latent_dim) is drawn from
    ``state.draws`` unless passed in. ``out`` holds ``d_loss``, ``g_loss``
    and ``gen_imgs`` (NCHW). D's BatchNorm statistics advance through its
    three forwards (the fakes in the G phase, then the real batch and the
    fakes). Under data parallelism (``state.dp``) z is the global batch's,
    drawn or passed in, the step keeps this rank's rows, the pull-away term
    and the hinge are the global batch's and the losses in ``out`` global
    means. No host sync: ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())
    margin = max(1.0, cfg.batch_size / 64.0)  # ebgan.py:157

    def step(state: TrainState, imgs_u8, labels=None, z=None):
        del labels
        device = state.draws.device
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        dp = state.dp
        if z is None:
            z = torch.randn(global_batch(dp, real.shape[0]), cfg.latent_dim,
                            generator=state.draws, device=device)
        z = local_rows(dp, z)

        # G phase (ebgan.py:165-182).
        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        recon, emb = D(gen)
        fake = gen.detach()
        g_loss = mse(recon, fake) + LAMBDA_PT * pullaway(gather_rows(dp, emb))
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase (ebgan.py:188-202) on the real batch and the pre-update
        # fakes, detached.
        opt_d.zero_grad(set_to_none=True)
        real_recon, _ = D(real)
        fake_recon, _ = D(fake)
        d_loss = mse(real_recon, real) + fake_hinge(dp, fake_recon, fake, margin)
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
