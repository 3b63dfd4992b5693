"""Plain reference of ``dcgan-64``: PyTorch-GAN's dcgan/dcgan.py (Generator,
Discriminator, ``weights_init_normal``, BCE, the 1:1 Adam updates), written
with ``torch.nn`` alone, after the pattern of ``scripts/baseline_torch.py``.

Departures from dcgan.py, each also the port's documented behaviour:

- The weights come from one CPU ``torch.Generator`` seeded with the run's
  seed, drawn layer by layer in construction order (generator, then
  discriminator): Linear as torch's default init, conv weights N(0, 0.02)
  and BatchNorm scales N(1, 0.02) as ``weights_init_normal``, conv biases
  torch's default U(+-1/sqrt(fan_in)), which ``weights_init_normal`` leaves.
- z and the Dropout2d keep masks come from a device ``torch.Generator``
  seeded with the run's seed, drawn each step before any forward: z, then
  one (B, C, 1, 1) Bernoulli(0.75) mask a dropout for each of the
  discriminator's three forwards (on the fakes in the G phase, then the
  real batch and the fakes in the D phase); kept channels scaled by 1/0.75,
  as ``nn.Dropout2d`` does.
- ``precision`` (``reference/precision.py``) sets the convolutions' and
  linears' arithmetic: float32, or the cell's bfloat16, or a lower one for
  the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Precision, adam, normalize_uint8

P_DROP = 0.25
D_FILTERS = (16, 32, 64, 128)


class Generator(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.init_size = cfg["img_size"] // 4
        self.l1 = nn.Sequential(nn.Linear(cfg["latent_dim"], 128 * self.init_size ** 2))
        self.conv_blocks = nn.Sequential(
            nn.BatchNorm2d(128),
            nn.Upsample(scale_factor=2),
            nn.Conv2d(128, 128, 3, stride=1, padding=1),
            nn.BatchNorm2d(128, 0.8),
            nn.LeakyReLU(0.2),
            nn.Upsample(scale_factor=2),
            nn.Conv2d(128, 64, 3, stride=1, padding=1),
            nn.BatchNorm2d(64, 0.8),
            nn.LeakyReLU(0.2),
            nn.Conv2d(64, cfg["channels"], 3, stride=1, padding=1),
            nn.Tanh(),
        )

    def forward(self, z: torch.Tensor, prec: Precision) -> torch.Tensor:
        out = prec.linear(self.l1[0], z)
        x = out.view(out.shape[0], 128, self.init_size, self.init_size)
        for layer in self.conv_blocks:
            x = prec.conv2d(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
        return x


class Discriminator(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()

        def block(in_filters, out_filters, bn=True):
            layers = [nn.Conv2d(in_filters, out_filters, 3, 2, 1), nn.LeakyReLU(0.2),
                      nn.Dropout2d(P_DROP)]
            if bn:
                layers.append(nn.BatchNorm2d(out_filters, 0.8))
            return layers

        self.model = nn.Sequential(
            *block(cfg["channels"], 16, bn=False), *block(16, 32), *block(32, 64),
            *block(64, 128))
        ds_size = cfg["img_size"] // 2 ** 4
        self.adv_layer = nn.Sequential(nn.Linear(128 * ds_size ** 2, 1), nn.Sigmoid())

    def forward(self, img: torch.Tensor, masks, prec: Precision) -> torch.Tensor:
        masks, x = iter(masks), img
        for layer in self.model:
            if isinstance(layer, nn.Conv2d):
                x = prec.conv2d(layer, x)
            elif isinstance(layer, nn.Dropout2d):
                x = x / (1.0 - P_DROP) * next(masks).to(x.dtype)
            else:
                x = layer(x)
        x = x.reshape(x.shape[0], -1)
        return self.adv_layer[1](prec.linear(self.adv_layer[0], x))


@torch.no_grad()
def _init(module: nn.Module, gen: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=gen)
            bound = 1.0 / math.sqrt(m.in_features)
            m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.02, generator=gen)
            bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0] * m.kernel_size[1])
            m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=gen)
            m.bias.zero_()


def build(cfg: dict, seed: int, device) -> dict:
    """Generator and discriminator with weights drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    modules = {"generator": Generator(cfg), "discriminator": Discriminator(cfg)}
    for m in modules.values():
        _init(m, gen)
    return {k: m.to(device) for k, m in modules.items()}


class Trainer:
    """dcgan.py:143-183 on ``modules``: each ``step(imgs_u8)`` takes one NHWC
    uint8 batch, makes one G update and one D update, and returns the two
    losses. ``draws`` is the device generator of z and the masks."""

    def __init__(self, cfg: dict, modules: dict, draws: torch.Generator, precision: str):
        self.cfg, self.draws = cfg, draws
        self.G, self.D = modules["generator"], modules["discriminator"]
        self.prec = Precision(precision)
        self.optimizers = {"generator": adam(self.G.parameters(), cfg),
                           "discriminator": adam(self.D.parameters(), cfg)}

    def _masks(self, b: int, device):
        return [torch.bernoulli(torch.full((b, c, 1, 1), 1.0 - P_DROP, device=device),
                                generator=self.draws) for c in D_FILTERS]

    def step(self, imgs_u8: torch.Tensor) -> dict:
        device = self.draws.device
        real = normalize_uint8(imgs_u8.to(device))
        b = real.shape[0]
        z = torch.randn(b, self.cfg["latent_dim"], generator=self.draws, device=device)
        masks = [self._masks(b, device) for _ in range(3)]
        opt_g, opt_d = self.optimizers["generator"], self.optimizers["discriminator"]
        bce = lambda p, t: F.binary_cross_entropy(p.float(), torch.full_like(p.float(), t))
        with self.prec.matmul_mode():
            opt_g.zero_grad()
            gen_imgs = self.G(z, self.prec)
            g_loss = bce(self.D(gen_imgs, masks[0], self.prec), 1.0)
            g_loss.backward()
            opt_g.step()

            opt_d.zero_grad()
            real_loss = bce(self.D(real, masks[1], self.prec), 1.0)
            fake_loss = bce(self.D(gen_imgs.detach(), masks[2], self.prec), 0.0)
            d_loss = (real_loss + fake_loss) / 2
            d_loss.backward()
            opt_d.step()
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}


def needed_step(cfg: dict, device) -> None:
    """The step's arithmetic with each gradient taken only where an update
    needs it, on any inputs (``counting.count_step`` runs it on ``meta``)."""
    prec = Precision("float32")
    m = build(cfg, 0, device)
    G, D = m["generator"], m["discriminator"]
    b = cfg["batch_size"]
    z = torch.randn(b, cfg["latent_dim"], device=device)
    real = torch.zeros(b, cfg["channels"], cfg["img_size"], cfg["img_size"], device=device)
    masks = [torch.ones(b, c, 1, 1, device=device) for c in D_FILTERS]
    gen = G(z, prec)
    torch.autograd.grad(D(gen, masks, prec).mean(), list(G.parameters()))
    d_loss = D(real, masks, prec).mean() + D(gen.detach(), masks, prec).mean()
    torch.autograd.grad(d_loss, list(D.parameters()))
