"""Coupled GAN (Liu & Tuzel 2016): the port of ``tpugan/models/cogan.py``.

Coupled generators share a Linear and a conv trunk and split into two heads,
G1 and G2 (cogan/cogan.py:51-87); coupled discriminators share a conv trunk,
applied to the first domain's images and then the second's, so its
BatchNorm statistics see them in that order, and split into two linear
heads, D1 and D2 (cogan.py:90-122). MSE adversarial loss averaged over both
domains (cogan.py:126, 210, 225-230), on MNIST (grey, repeated to three
channels) zipped with MNIST-M at 32px, batch 32. This script's
``weights_init_normal`` matches Linear and BatchNorm (cogan.py:42-48): the
convs keep torch's default init.

The discriminator's blocks are Conv, [BatchNorm(0.8)], LeakyReLU(0.2),
Dropout2d(0.25) (cogan.py:94-99); each trunk application takes its own
four Dropout2d keep masks, passed in or drawn from the state's device
generator. The step reaches no kernel of the port (the JAX path reaches no
Pallas kernel); it makes no host read, so ``--steps_per_dispatch K`` runs it
inside a CUDA graph through ``run_training``.

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
from torch import nn

from tpugan_torch.losses import mse
from tpugan_torch.models._common import save_grid, std_log_line, two_domain_loader
from tpugan_torch.nn.blocks import forward_masked
from tpugan_torch.nn.layers import BatchNorm2d, Conv2d, Dropout2d, LeakyReLU, Linear, Upsample
from tpugan_torch.train.loop import Callbacks, run_training, train_device
from tpugan_torch.train.optim import capturable
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "cogan"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with cogan.py:23-33 and tpugan.models.cogan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(32, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(400, "interval betwen image samples")


def _conv(i, o, stride, gen):
    return Conv2d(i, o, 3, stride, 1, init_mode="torch", generator=gen)


def _bn(c, eps, gen):
    return BatchNorm2d(c, eps, init_mode="normal02", generator=gen)


class CoupledGenerators(nn.Module):
    """cogan.py:51-87: ``fc`` (Linear to 128 x (s/4)^2, viewed NCHW),
    ``shared_conv`` (BatchNorm2d(128), Upsample, Conv3, BatchNorm2d(128,
    0.8), LeakyReLU(0.2), Upsample), then ``G1`` and ``G2`` (Conv3,
    BatchNorm2d(64, 0.8), LeakyReLU(0.2), Conv3 to the channels, tanh).
    Returns (img1, img2)."""

    def __init__(self, img_size: int, channels: int, latent_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.init_size = img_size // 4
        self.fc = nn.Sequential(Linear(latent_dim, 128 * self.init_size ** 2,
                                       init_mode="normal02", generator=g))
        self.shared_conv = nn.Sequential(
            _bn(128, 1e-5, g), Upsample(2), _conv(128, 128, 1, g), _bn(128, 0.8, g),
            LeakyReLU(0.2), Upsample(2))
        head = lambda: nn.Sequential(_conv(128, 64, 1, g), _bn(64, 0.8, g), LeakyReLU(0.2),
                                     _conv(64, channels, 1, g), nn.Tanh())
        self.G1 = head()
        self.G2 = head()

    def forward(self, z: torch.Tensor):
        out = self.fc(z).view(z.shape[0], 128, self.init_size, self.init_size)
        emb = self.shared_conv(out)
        return self.G1(emb), self.G2(emb)


class CoupledDiscriminators(nn.Module):
    """cogan.py:90-122: ``shared_conv``, four blocks of Conv3 stride 2,
    [BatchNorm2d(0.8)], LeakyReLU(0.2), Dropout2d(0.25) to 16, 32, 64 and 128
    filters (no norm in the first), applied to img1 and then img2; ``D1`` and
    ``D2``, Linear to 1 on each flattened map. ``forward(img1, img2,
    masks=None)`` takes eight keep masks in training, four a trunk
    application in call order (``draw_masks``), and returns (validity1,
    validity2)."""

    def __init__(self, img_size: int, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        layers, fan_in = [], channels
        for i, f in enumerate((16, 32, 64, 128)):
            layers.append(_conv(fan_in, f, 2, g))
            if i > 0:
                layers.append(_bn(f, 0.8, g))
            layers += [LeakyReLU(0.2), Dropout2d(0.25)]
            fan_in = f
        self.shared_conv = nn.Sequential(*layers)
        feat = 128 * (img_size // 2 ** 4) ** 2
        self.D1 = Linear(feat, 1, init_mode="normal02", generator=g)
        self.D2 = Linear(feat, 1, init_mode="normal02", generator=g)

    def draw_masks(self, batch: int, generator: torch.Generator) -> list:
        """Eight (batch, C, 1, 1) keep masks: the trunk's four on img1, then
        its four on img2."""
        convs = [m for m in self.shared_conv if isinstance(m, Conv2d)]
        drops = [m for m in self.shared_conv if isinstance(m, Dropout2d)]
        return [d.draw_mask((batch, c.out_channels, 1, 1), generator)
                for _ in range(2) for c, d in zip(convs, drops)]

    def _trunk(self, img, masks):
        x = forward_masked(self.shared_conv, img, masks)
        return x.reshape(x.shape[0], -1)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None):
        m1, m2 = (masks[:4], masks[4:]) if masks is not None else (None, None)
        validity1 = self.D1(self._trunk(img1, m1))
        return validity1, self.D2(self._trunk(img2, m2))


def build(cfg: Config, device) -> dict:
    """The coupled generators and discriminators, weights drawn from a
    generator seeded by ``--seed`` (on the CPU, so they do not depend on the
    device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": CoupledGenerators(cfg.img_size, cfg.channels, cfg.latent_dim, generator=gen),
        "discriminator": CoupledDiscriminators(cfg.img_size, cfg.channels, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam for each pair, capturable on CUDA, and a device generator of the
    draws seeded by ``--seed``."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                      **capturable(device))
    opts = {k: adam(modules[k]) for k in ("generator", "discriminator")}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, opts, draws)


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs1_u8, labels1, imgs2_u8, labels2, z=None, masks=None)
    -> (state, out)``: one update of the generators, then one of the
    discriminators on the real pair and the detached fakes (cogan.py:200-233).
    ``z`` is (B, latent_dim) N(0, 1); ``masks`` holds the eight keep masks of
    each of the three discriminator forwards (G phase, real pair, fakes).
    Both are drawn from ``state.draws``, z first, unless passed. ``out``
    holds ``d_loss`` and ``g_loss`` (0-d) and ``gen_imgs1``, ``gen_imgs2``
    (NCHW)."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs1_u8, labels1, imgs2_u8, labels2, z=None, masks=None):
        del labels1, labels2
        device = state.draws.device
        imgs1 = normalize_uint8(imgs1_u8.to(device, non_blocking=True))
        imgs2 = normalize_uint8(imgs2_u8.to(device, non_blocking=True))
        b = imgs1.shape[0]
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if masks is None:
            masks = [D.draw_masks(b, state.draws) for _ in range(3)]

        opt_g.zero_grad(set_to_none=True)
        gen1, gen2 = G(z)
        v1, v2 = D(gen1, gen2, masks[0])
        g_loss = (mse(v1, 1.0) + mse(v2, 1.0)) / 2
        g_loss.backward(inputs=g_params)
        opt_g.step()

        fake1, fake2 = gen1.detach(), gen2.detach()
        opt_d.zero_grad(set_to_none=True)
        v1r, v2r = D(imgs1, imgs2, masks[1])
        v1f, v2f = D(fake1, fake2, masks[2])
        d_loss = (mse(v1r, 1.0) + mse(v1f, 0.0) + mse(v2r, 1.0) + mse(v2f, 0.0)) / 4
        d_loss.backward()
        opt_d.step()
        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                       "gen_imgs1": fake1, "gen_imgs2": fake2}

    return step


make_loader = two_domain_loader


def run(cfg: Config, device=None) -> TrainState:
    """Train through ``run_training`` (``--steps_per_dispatch K`` fuses K
    steps in a CUDA graph). ``device`` None means CUDA, and raises when there
    is none; the tests pass the CPU. On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    state = create_state(cfg, modules, device)
    loader = make_loader(cfg, device)
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)

    def sample(state, out, batches_done):
        # cogan.py:241-243: both domains' batches stacked, 8 a row.
        save_grid(torch.cat([out["gen_imgs1"], out["gen_imgs2"]]),
                  os.path.join(imgdir, "%d.png" % batches_done), 8)

    return run_training(cfg, loader, state, make_step(cfg, state),
                        Callbacks(log=std_log_line(cfg), sample=sample),
                        n_epochs=cfg.n_epochs, sample_interval=cfg.sample_interval)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
