"""pix2pix (Isola et al. 2017), paired image-to-image translation: the port
of ``tpugan/models/pix2pix.py``.

The 8-down/7-up U-Net generator (pix2pix/models.py:55-101), a conditional
PatchGAN on cat(img_A, img_B) with no head bias (models.py:109-133), MSE GAN
loss plus 100 * L1 pixel loss (pix2pix.py:50-54, 140-148), Adam(2e-4, 0.5,
0.999) for each, at 256px, batch 1. The direction swap is kept
(pix2pix.py:127-128): the dataset's A is the left half, B the right, and
training conditions on B (``real_A = batch["B"]``) to predict A.

Every IN of the generator and the discriminator runs through the port's
instance-norm kernel pair (``nn/im2im.py``). Dropout stays active in
sampling, as the reference samples the train-mode generator; the sampler
draws its masks from a generator of its own. Checkpoints are
``generator_<E>.pth``/``discriminator_<E>.pth``, resumed with ``--epoch N``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpugan_torch.losses import l1, mse
from tpugan_torch.models._common import sample_generator, save_grid
from tpugan_torch.models._im2im_common import (
    first_batch,
    maybe_resume,
    out_dirs,
    paired_loader,
    run_per_step,
)
from tpugan_torch.nn.im2im import GeneratorUNet, PatchGAN
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "pix2pix"
MODULES = ("generator", "discriminator")
LAMBDA_PIXEL = 100.0  # pix2pix.py:54


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with pix2pix.py:24-41 and tpugan.models.pix2pix.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("facades", "name of the dataset")
    batch_size: int = flag(1, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(256, "size of image height")
    img_width: int = flag(256, "size of image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(
        500, "interval between sampling of images from generators"
    )
    checkpoint_interval: int = flag(-1, "interval between model checkpoints")


class CondPatchGAN(PatchGAN):
    """The conditional discriminator (pix2pix/models.py:109-133): PatchGAN
    on cat(img_a, img_b) along the channels, no head bias."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__(2 * channels, head_bias=False, generator=generator,
                         init_mode="normal02")

    def forward(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        return self.model(torch.cat([img_a, img_b], dim=1))


def build(cfg: Config, device) -> dict:
    """The generator and discriminator with weights drawn from a generator
    seeded by ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {"generator": GeneratorUNet(cfg.channels, cfg.channels, generator=gen),
               "discriminator": CondPatchGAN(cfg.channels, generator=gen)}
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) for each module and a device generator of the
    dropout draws seeded by ``--seed``."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, {k: adam(m) for k, m in modules.items()}, draws)


def make_step(cfg: Config, state: TrainState):
    """``step(state, a_u8, b_u8, masks=None) -> (state, out)``: one G update,
    then one D update (pix2pix.py:138-172). ``masks`` holds the keep masks
    of the generator's nine dropout sites in call order; None draws them
    from ``state.draws``. D sees the real and the fake pair in one forward
    (its norms are per sample). ``out`` holds ``d_loss``, ``g_loss``,
    ``loss_pixel`` and ``loss_GAN`` as 0-d tensors."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, a_u8, b_u8, masks=None):
        device = state.draws.device
        real_a = normalize_uint8(b_u8.to(device, non_blocking=True))  # the swap
        real_b = normalize_uint8(a_u8.to(device, non_blocking=True))
        n = real_a.shape[0]

        opt_g.zero_grad(set_to_none=True)
        fake_b = G(real_a, masks, state.draws)
        loss_gan = mse(D(fake_b, real_a), 1.0)
        loss_pixel = l1(fake_b, real_b)
        g_loss = loss_gan + LAMBDA_PIXEL * loss_pixel
        g_loss.backward(inputs=g_params)
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        pred = D(torch.cat([real_b, fake_b.detach()]), torch.cat([real_a, real_a]))
        d_loss = 0.5 * (mse(pred[:n], 1.0) + mse(pred[n:], 0.0))
        d_loss.backward()
        opt_d.step()

        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                       "loss_pixel": loss_pixel.detach(), "loss_GAN": loss_gan.detach()}

    return step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2):
    return paired_loader(cfg, device, cfg.img_height, cfg.img_width, split, batch_size, prefetch)


def make_sampler(cfg: Config, modules: dict, device):
    """pix2pix.py:107-114: 10 validation pairs, each real_A over fake_B over
    real_B, 5 a row, to images/<dataset>/<N>.png. The train-mode generator,
    its dropout masks drawn from ``_common.sample_generator``."""
    G = modules["generator"]
    val_loader = make_loader(cfg, device, split="val", batch_size=10, prefetch=0)
    imgdir, _ = out_dirs(cfg)

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, b_u8 = first_batch(val_loader, batches_done)
        real_a, real_b = normalize_uint8(b_u8), normalize_uint8(a_u8)
        fake_b = G(real_a, generator=sample_generator(cfg, batches_done, real_a.device))
        save_grid(torch.cat([real_a, fake_b, real_b], dim=2),
                  "%s/%s.png" % (imgdir, batches_done), 5)

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
        lambda out: "[D loss: %f] [G loss: %f, pixel: %f, adv: %f]" % (
            float(out["d_loss"]), float(out["g_loss"]), float(out["loss_pixel"]),
            float(out["loss_GAN"])),
        modules, MODULES)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
