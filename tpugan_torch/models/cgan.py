"""Conditional GAN (Mirza & Osindero 2014): the port of
``tpugan/models/cgan.py``.

MLP generator and discriminator on MNIST at 32px, each with a label
Embedding(n_classes, n_classes) concatenated to its input: [emb, z] in G
(cgan.py:43-65), [flattened image, emb] in D (cgan.py:69-91), D with two
Dropout(0.4) and no Sigmoid; the MSE adversarial loss (cgan.py:95), 1:1
Adam(2e-4, 0.5, 0.999) updates, G first. Samples: n_classes^2 images of the
label grid [0..n-1] repeated, n_classes a row (cgan.py:129-137). No kernel
of the port runs here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from tpugan_torch.losses import mse
from tpugan_torch.models._common import (
    mnist_loader,
    run_mnist_recipe,
    sample_noise,
    save_grid,
    std_log_line,
)
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.nn.blocks import forward_masked, mlp_generator_body
from tpugan_torch.nn.layers import (
    Dropout,
    Embedding,
    LeakyReLU,
    Linear,
    batch_stats_frozen,
    rank_local,
)
from tpugan_torch.parallel.mesh import global_batch, global_means, local_rows, rank_zero_write
from tpugan_torch.train.loop import Callbacks
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "cgan"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with cgan.py:20-30 and tpugan.models.cgan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    n_classes: int = flag(10, "number of classes for dataset")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(1, "number of image channels")
    sample_interval: int = flag(400, "interval between image sampling")


class CGANGenerator(nn.Module):
    """``label_emb``, then template A's ``model`` on [emb, z], viewed as
    (B, C, H, W) (cgan.py:43-65)."""

    def __init__(self, img_shape: Tuple[int, int, int], latent_dim: int, n_classes: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_shape = tuple(img_shape)  # (C, H, W)
        self.label_emb = Embedding(n_classes, n_classes, generator=generator)
        self.model = mlp_generator_body(latent_dim + n_classes, math.prod(self.img_shape),
                                        generator=generator)

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.label_emb(labels), z], dim=-1)
        return self.model(x).view(z.shape[0], *self.img_shape)


class CGANDiscriminator(nn.Module):
    """``label_embedding``, then ``model`` on [img.view(B, -1), emb]:
    Linear(512), LReLU, Linear(512), Dropout(0.4), LReLU, Linear(512),
    Dropout(0.4), LReLU, Linear(1) (cgan.py:69-91). In training ``forward``
    takes the two Dropout keep masks (``draw_masks``)."""

    def __init__(self, in_features: int, n_classes: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.label_embedding = Embedding(n_classes, n_classes, generator=generator)
        lin = lambda i, o: Linear(i, o, generator=generator)
        self.model = nn.Sequential(
            lin(in_features + n_classes, 512), LeakyReLU(0.2),
            lin(512, 512), Dropout(0.4), LeakyReLU(0.2),
            lin(512, 512), Dropout(0.4), LeakyReLU(0.2),
            lin(512, 1),
        )

    def draw_masks(self, batch: int, generator: torch.Generator) -> list:
        """One (batch, 512) keep mask for each Dropout, in call order."""
        return [layer.draw_mask((batch, 512), generator) for layer in self.model
                if isinstance(layer, Dropout)]

    def forward(self, img: torch.Tensor, labels: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        x = torch.cat([img.reshape(img.shape[0], -1), self.label_embedding(labels)], dim=-1)
        return forward_masked(self.model, x, masks)


def build(cfg: Config, device) -> dict:
    """G and D with weights drawn from a generator seeded by ``--seed`` (on
    the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    img_shape = (cfg.channels, cfg.img_size, cfg.img_size)
    modules = {
        "generator": CGANGenerator(img_shape, cfg.latent_dim, cfg.n_classes, generator=gen),
        "discriminator": CGANDiscriminator(math.prod(img_shape), cfg.n_classes, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b
make_loader = mnist_loader


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, labels, z=None, gen_labels=None, masks=None)
    -> (state, out)``: one G update on fresh labels, then one D update on
    the real batch with its labels and on the fakes with theirs
    (``tpugan/models/cgan.py:118-181``).

    Draws, from ``state.draws`` in this order unless passed in: ``z`` (B,
    latent_dim), ``gen_labels`` (B,) uniform over the classes, and
    ``masks``, the Dropout keep masks of D's three forwards (G phase, real,
    fakes). Under data parallelism (``state.dp``) the draws are the global
    batch's, drawn or passed in, the step keeps this rank's rows and the
    losses in ``out`` are global means. No host sync: ``graph_steps`` can
    capture it."""
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
        g_loss = mse(D(gen, gen_labels, masks[0]), 1.0)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        fake = gen.detach()
        opt_d.zero_grad(set_to_none=True)
        d_loss = 0.5 * (mse(D(real, labels, masks[1]), 1.0)
                        + mse(D(fake, gen_labels, masks[2]), 0.0))
        d_loss.backward()
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "gen_imgs": fake}
        return state, global_means(dp, out, ("d_loss", "g_loss"))

    return step


def class_grid(n_row: int, device) -> torch.Tensor:
    """The samplers' labels: 0..n_row-1, n_row times over (cgan.py:133)."""
    return torch.arange(n_row, device=device).repeat(n_row)


def make_sampler(cfg: Config):
    """``sample(state, out, batches_done)``: G, in training mode as the
    reference leaves it, on the class grid with noise from
    ``_common.sample_noise`` (its own generator: ``state.draws`` stays as it
    was), to ``images/<batches_done>.png``, n_classes a row. G's BatchNorm
    running statistics stay as they were (``batch_stats_frozen``), as the
    JAX sampler drops its update. Under data parallelism rank 0 alone
    samples, its BatchNorm on the sample batch alone (``rank_local``)."""
    n_row = cfg.n_classes
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)

    @torch.no_grad()
    def write(state, batches_done):
        G = state.modules["generator"]
        device = state.draws.device
        z = sample_noise(cfg, batches_done, (n_row * n_row, cfg.latent_dim), device)
        with rank_local(G), batch_stats_frozen(G):
            imgs = G(z, class_grid(n_row, device))
        save_grid(imgs, os.path.join(imgdir, "%d.png" % batches_done), n_row)

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
