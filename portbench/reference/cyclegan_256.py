"""Plain reference of ``cyclegan-256``: PyTorch-GAN's cyclegan/models.py
(GeneratorResNet, ResidualBlock, Discriminator, ``weights_init_normal``),
utils.py (ReplayBuffer) and the training step of cyclegan.py:177-239,
written with ``torch.nn`` alone, after the pattern of
``scripts/baseline_torch_cyclegan.py``. Instance norm is
``F.instance_norm``.

Departures from the reference, each also the port's documented behaviour:

- The weights come from one CPU ``torch.Generator`` seeded with the run's
  seed: every conv weight N(0, 0.02), drawn in construction order (G_AB,
  G_BA, D_A, D_B), every bias 0, as ``weights_init_normal``.
- The replay buffers draw from one CPU ``torch.Generator`` seeded with the
  run's seed, shared by both: for a batch, a uniform coin for each element
  that arrives with the buffer full, then an index for each; none while it
  fills (the first 50 images).
- The learning-rate schedule is left out: its factor is 1 until
  ``decay_epoch`` (100), far past what a run trains.
- ``precision`` (``reference/precision.py``) sets the convolutions'
  arithmetic: float32, or a lower one for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Precision, adam, normalize_uint8

MODULES = ("G_AB", "G_BA", "D_A", "D_B")


def _in(x: torch.Tensor) -> torch.Tensor:
    """nn.InstanceNorm2d(affine=False), float32 statistics."""
    return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def _apply(layers: nn.Sequential, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    for layer in layers:
        if isinstance(layer, nn.Conv2d):
            x = prec.conv2d(layer, x)
        elif isinstance(layer, nn.InstanceNorm2d):
            x = _in(x)
        elif isinstance(layer, ResidualBlock):
            x = layer(x, prec)
        else:
            x = layer(x)
    return x


class ResidualBlock(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1),
            nn.Conv2d(in_features, in_features, 3),
            nn.InstanceNorm2d(in_features),
            nn.ReLU(),
            nn.ReflectionPad2d(1),
            nn.Conv2d(in_features, in_features, 3),
            nn.InstanceNorm2d(in_features),
        )

    def forward(self, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        return x + _apply(self.block, x, prec)


class GeneratorResNet(nn.Module):
    def __init__(self, channels: int, num_residual_blocks: int):
        super().__init__()
        out_features = 64
        model = [nn.ReflectionPad2d(channels), nn.Conv2d(channels, out_features, 7),
                 nn.InstanceNorm2d(out_features), nn.ReLU()]
        in_features = out_features
        for _ in range(2):
            out_features *= 2
            model += [nn.Conv2d(in_features, out_features, 3, stride=2, padding=1),
                      nn.InstanceNorm2d(out_features), nn.ReLU()]
            in_features = out_features
        model += [ResidualBlock(out_features) for _ in range(num_residual_blocks)]
        for _ in range(2):
            out_features //= 2
            model += [nn.Upsample(scale_factor=2),
                      nn.Conv2d(in_features, out_features, 3, stride=1, padding=1),
                      nn.InstanceNorm2d(out_features), nn.ReLU()]
            in_features = out_features
        model += [nn.ReflectionPad2d(channels), nn.Conv2d(out_features, channels, 7), nn.Tanh()]
        self.model = nn.Sequential(*model)

    def forward(self, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        return _apply(self.model, x, prec)


class Discriminator(nn.Module):
    def __init__(self, channels: int):
        super().__init__()

        def block(in_filters, out_filters, normalize=True):
            layers = [nn.Conv2d(in_filters, out_filters, 4, stride=2, padding=1)]
            if normalize:
                layers.append(nn.InstanceNorm2d(out_filters))
            layers.append(nn.LeakyReLU(0.2))
            return layers

        self.model = nn.Sequential(
            *block(channels, 64, normalize=False), *block(64, 128), *block(128, 256),
            *block(256, 512), nn.ZeroPad2d((1, 0, 1, 0)), nn.Conv2d(512, 1, 4, padding=1))

    def forward(self, img: torch.Tensor, prec: Precision) -> torch.Tensor:
        return _apply(self.model, img, prec)


def build(cfg: dict, seed: int, device) -> dict:
    """G_AB, G_BA, D_A, D_B with weights drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    g = lambda: GeneratorResNet(cfg["channels"], cfg["n_residual_blocks"])
    d = lambda: Discriminator(cfg["channels"])
    modules = {"G_AB": g(), "G_BA": g(), "D_A": d(), "D_B": d()}
    with torch.no_grad():
        for m in modules.values():
            for layer in m.modules():
                if isinstance(layer, nn.Conv2d):
                    layer.weight.normal_(0.0, 0.02, generator=gen)
                    layer.bias.zero_()
    return {k: m.to(device) for k, m in modules.items()}


class ReplayBuffer:
    """utils.py:13-33, with the draws described above."""

    def __init__(self, max_size: int, draws: torch.Generator):
        self.max_size, self.draws, self.data = max_size, draws, []

    def push_and_pop(self, batch: torch.Tensor) -> torch.Tensor:
        n_full = max(0, len(batch) - max(0, self.max_size - len(self.data)))
        coins = torch.rand(n_full, generator=self.draws).tolist()
        idxs = torch.randint(0, self.max_size, (n_full,), generator=self.draws).tolist()
        out, draw = [], 0
        for element in batch.detach():
            element = element.unsqueeze(0)
            if len(self.data) < self.max_size:
                self.data.append(element)
                out.append(element)
                continue
            coin, i = coins[draw], idxs[draw]
            draw += 1
            if coin > 0.5:
                out.append(self.data[i].clone())
                self.data[i] = element
            else:
                out.append(element)
        return torch.cat(out)


class Trainer:
    """cyclegan.py:177-239 on ``modules``: each ``step(a_u8, b_u8)`` takes one
    NHWC uint8 batch of each domain, makes one G update and one update of
    D_A and of D_B, and returns the five losses."""

    def __init__(self, cfg: dict, modules: dict, seed: int, precision: str):
        self.cfg = cfg
        self.m = modules
        self.prec = Precision(precision)
        params_g = [*modules["G_AB"].parameters(), *modules["G_BA"].parameters()]
        self.optimizers = {"G": adam(params_g, cfg), "D_A": adam(modules["D_A"].parameters(), cfg),
                           "D_B": adam(modules["D_B"].parameters(), cfg)}
        draws = torch.Generator().manual_seed(seed)
        self.buffers = {"A": ReplayBuffer(50, draws), "B": ReplayBuffer(50, draws)}

    def step(self, a_u8: torch.Tensor, b_u8: torch.Tensor) -> dict:
        G_AB, G_BA, D_A, D_B = (self.m[k] for k in MODULES)
        device = next(G_AB.parameters()).device
        real_A, real_B = normalize_uint8(a_u8.to(device)), normalize_uint8(b_u8.to(device))
        p = self.prec
        mse = lambda x, t: torch.mean((x.float() - t) ** 2)
        l1 = lambda x, y: torch.mean(torch.abs(x.float() - y))
        with p.matmul_mode():
            opt_G = self.optimizers["G"]
            opt_G.zero_grad()
            loss_id_A = l1(G_BA(real_A, p), real_A)
            loss_id_B = l1(G_AB(real_B, p), real_B)
            loss_identity = (loss_id_A + loss_id_B) / 2
            fake_B = G_AB(real_A, p)
            loss_GAN_AB = mse(D_B(fake_B, p), 1.0)
            fake_A = G_BA(real_B, p)
            loss_GAN_BA = mse(D_A(fake_A, p), 1.0)
            loss_GAN = (loss_GAN_AB + loss_GAN_BA) / 2
            loss_cycle_A = l1(G_BA(fake_B, p), real_A)
            loss_cycle_B = l1(G_AB(fake_A, p), real_B)
            loss_cycle = (loss_cycle_A + loss_cycle_B) / 2
            loss_G = (loss_GAN + self.cfg["lambda_cyc"] * loss_cycle
                      + self.cfg["lambda_id"] * loss_identity)
            loss_G.backward()
            opt_G.step()

            losses_D = []
            for name, D, real, fake, buf in (("D_A", D_A, real_A, fake_A, "A"),
                                              ("D_B", D_B, real_B, fake_B, "B")):
                opt = self.optimizers[name]
                opt.zero_grad()
                loss_real = mse(D(real, p), 1.0)
                fake_ = self.buffers[buf].push_and_pop(fake)
                loss_fake = mse(D(fake_.detach(), p), 0.0)
                loss_D = (loss_real + loss_fake) / 2
                loss_D.backward()
                opt.step()
                losses_D.append(loss_D.detach())
        return {"d_loss": (losses_D[0] + losses_D[1]) / 2, "g_loss": loss_G.detach(),
                "loss_GAN": loss_GAN.detach(), "loss_cycle": loss_cycle.detach(),
                "loss_identity": loss_identity.detach()}


def needed_step(cfg: dict, device) -> None:
    """The step's arithmetic with each gradient taken only where an update
    needs it (the G phase reaches the generators' weights through the
    discriminators, not the discriminators' weights), on any inputs
    (``counting.count_step`` runs it on ``meta``)."""
    prec = Precision("float32")
    m = build(cfg, 0, device)
    G_AB, G_BA, D_A, D_B = (m[k] for k in MODULES)
    shape = (cfg["batch_size"], cfg["channels"], cfg["img_height"], cfg["img_width"])
    real_A, real_B = torch.zeros(shape, device=device), torch.zeros(shape, device=device)
    fake_B, fake_A = G_AB(real_A, prec), G_BA(real_B, prec)
    g_loss = (G_BA(real_A, prec).mean() + G_AB(real_B, prec).mean()
              + D_B(fake_B, prec).mean() + D_A(fake_A, prec).mean()
              + G_BA(fake_B, prec).mean() + G_AB(fake_A, prec).mean())
    torch.autograd.grad(g_loss, [*G_AB.parameters(), *G_BA.parameters()])
    for D, real, fake in ((D_A, real_A, fake_A), (D_B, real_B, fake_B)):
        torch.autograd.grad(D(real, prec).mean() + D(fake.detach(), prec).mean(),
                            list(D.parameters()))
