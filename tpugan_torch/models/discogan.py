"""DiscoGAN (Kim et al. 2017): the port of ``tpugan/models/discogan.py``.

Two 6-down/5-up U-Nets with biased convs (discogan/models.py:20-86) and two
3-block PatchGAN discriminators (patch H/8, models.py:94-120), at 64px,
batch 64, on paired data. Losses (discogan.py:150-167): MSE GAN + cycle L1 +
pixelwise L1 to the opposite domain, unweighted; one Adam over both
generators and one per discriminator (discogan.py:83-87); the D steps take
the G phase's fakes, detached.

Every IN runs through the port's instance-norm kernel pair (``nn/im2im.py``),
at batch 64 down to the 2x2 maps of ``up1``. The sampler runs the generators
in eval mode (dropout off), as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import l1, mse
from tpugan_torch.models._common import save_grid
from tpugan_torch.models._im2im_common import (
    first_batch,
    maybe_resume,
    out_dirs,
    paired_loader,
    run_per_step,
)
from tpugan_torch.nn.im2im import PatchGAN, UNet, UNetDown, UNetUp, _numbered
from tpugan_torch.nn.layers import Conv2d, Upsample, ZeroPadLT
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "discogan"
MODULES = ("G_AB", "G_BA", "D_A", "D_B")


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with discogan.py:24-37 and tpugan.models.discogan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("edges2shoes", "name of the dataset")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(64, "size of image height")
    img_width: int = flag(64, "size of image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(100, "interval between saving generator samples")
    checkpoint_interval: int = flag(-1, "interval between model checkpoints")


class DiscoGenerator(UNet):
    """discogan/models.py:51-86: 6 downs and 5 ups with biased convs, IN,
    dropout 0.5 at d3-d6 and u1-u3 (seven sites), then Upsample,
    ZeroPad2d((1, 0, 1, 0)), a 4x4 conv and tanh."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        kw = dict(use_bias=True, generator=generator)
        downs = [UNetDown(channels, 64, normalize=False, **kw), UNetDown(64, 128, **kw),
                 UNetDown(128, 256, dropout=0.5, **kw), UNetDown(256, 512, dropout=0.5, **kw),
                 UNetDown(512, 512, dropout=0.5, **kw),
                 UNetDown(512, 512, normalize=False, dropout=0.5, **kw)]
        ups = [UNetUp(512, 512, dropout=0.5, **kw), UNetUp(1024, 512, dropout=0.5, **kw),
               UNetUp(1024, 256, dropout=0.5, **kw), UNetUp(512, 128, **kw),
               UNetUp(256, 64, **kw)]
        final = _numbered([(Upsample(2), 1), (ZeroPadLT(), 1),
                           (Conv2d(128, channels, 4, 1, 1, init_mode="normal02",
                                   generator=generator), 1), (nn.Tanh(), 1)])
        super().__init__(downs, ups, final)


def build(cfg: Config, device) -> dict:
    """G_AB, G_BA, D_A, D_B with weights drawn from a generator seeded by
    ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    g = lambda: DiscoGenerator(cfg.channels, generator=gen)
    d = lambda: PatchGAN(cfg.channels, head_bias=True, generator=gen, filters=(64, 128, 256),
                         init_mode="normal02")
    modules = {"G_AB": g(), "G_BA": g(), "D_A": d(), "D_B": d()}
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam over both generators, one for each discriminator, and a device
    generator of the dropout draws seeded by ``--seed``."""
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    opts = {"G": adam([*modules["G_AB"].parameters(), *modules["G_BA"].parameters()]),
            "D_A": adam(modules["D_A"].parameters()), "D_B": adam(modules["D_B"].parameters())}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, opts, draws)


def make_step(cfg: Config, state: TrainState):
    """``step(state, a_u8, b_u8, masks=None) -> (state, out)``: one update of
    both generators, then one of D_A and of D_B (discogan.py:145-203).
    ``masks`` holds, for the four generator forwards in order (G_AB(real_a),
    G_BA(real_b), G_BA(fake_b), G_AB(fake_a)), the keep masks of their seven
    dropout sites; None draws them from ``state.draws``. Each D sees the real
    and the fake batch in one forward. ``out`` holds ``d_loss``, ``g_loss``,
    ``loss_GAN``, ``loss_pixelwise`` and ``loss_cycle`` as 0-d tensors."""
    G_AB, G_BA, D_A, D_B = (state.modules[k] for k in MODULES)
    g_params = [*G_AB.parameters(), *G_BA.parameters()]

    def d_update(state, name, D, real, fake):
        opt = state.optimizers[name]
        opt.zero_grad(set_to_none=True)
        n = real.shape[0]
        pred = D(torch.cat([real, fake]))
        loss = (mse(pred[:n], 1.0) + mse(pred[n:], 0.0)) / 2
        loss.backward()
        opt.step()
        return loss.detach()

    def step(state: TrainState, a_u8, b_u8, masks=None):
        device = state.draws.device
        real_a = normalize_uint8(a_u8.to(device, non_blocking=True))
        real_b = normalize_uint8(b_u8.to(device, non_blocking=True))
        m = masks if masks is not None else [None] * 4

        opt_g = state.optimizers["G"]
        opt_g.zero_grad(set_to_none=True)
        fake_b = G_AB(real_a, m[0], state.draws)
        fake_a = G_BA(real_b, m[1], state.draws)
        loss_gan = (mse(D_B(fake_b), 1.0) + mse(D_A(fake_a), 1.0)) / 2
        loss_pixelwise = (l1(fake_a, real_a) + l1(fake_b, real_b)) / 2
        recov_a = G_BA(fake_b, m[2], state.draws)
        recov_b = G_AB(fake_a, m[3], state.draws)
        loss_cycle = (l1(recov_a, real_a) + l1(recov_b, real_b)) / 2
        g_loss = loss_gan + loss_cycle + loss_pixelwise
        g_loss.backward(inputs=g_params)
        opt_g.step()

        loss_d_a = d_update(state, "D_A", D_A, real_a, fake_a.detach())
        loss_d_b = d_update(state, "D_B", D_B, real_b, fake_b.detach())
        state.step += 1
        return state, {"d_loss": 0.5 * (loss_d_a + loss_d_b), "g_loss": g_loss.detach(),
                       "loss_GAN": loss_gan.detach(), "loss_pixelwise": loss_pixelwise.detach(),
                       "loss_cycle": loss_cycle.detach()}

    return step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2):
    return paired_loader(cfg, device, cfg.img_height, cfg.img_width, split, batch_size, prefetch)


def make_sampler(cfg: Config, modules: dict, device):
    """discogan.py:112-122: 16 validation pairs; rows real_A, fake_B, real_B,
    fake_A, 8 a row, to images/<dataset>/<N>.png; the generators in eval
    mode (dropout off), set back to training after."""
    G_AB, G_BA = modules["G_AB"], modules["G_BA"]
    val_loader = make_loader(cfg, device, split="val", batch_size=16, prefetch=0)
    imgdir, _ = out_dirs(cfg)

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, b_u8 = first_batch(val_loader, batches_done)
        real_a, real_b = normalize_uint8(a_u8), normalize_uint8(b_u8)
        G_AB.eval(), G_BA.eval()
        try:
            parts = (real_a, G_AB(real_a), real_b, G_BA(real_b))
        finally:
            G_AB.train(), G_BA.train()
        save_grid(torch.cat(parts), "%s/%s.png" % (imgdir, batches_done), 8)

    return sample


def run(cfg: Config, device=None) -> TrainState:
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    maybe_resume(modules, cfg, MODULES)
    state = create_state(cfg, modules, device)
    return run_per_step(
        cfg, make_loader(cfg, device), state, make_step(cfg, state),
        make_sampler(cfg, modules, device),
        lambda out: "[D loss: %f] [G loss: %f, adv: %f, pixel: %f, cycle: %f]" % (
            float(out["d_loss"]), float(out["g_loss"]), float(out["loss_GAN"]),
            float(out["loss_pixelwise"]), float(out["loss_cycle"])),
        modules, MODULES)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
