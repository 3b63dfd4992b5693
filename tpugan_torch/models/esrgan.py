"""ESRGAN (Wang et al. 2018): the port of ``tpugan/models/esrgan.py``, with
the inference entry of ``test_on_image``.

The RRDB generator (23 residual-in-residual dense blocks by default,
``--residual_blocks``; no norms, 0.2 residual scaling), the SR
discriminator and the VGG19 features[:35] content loss ("vgg19_54", conv5_4
before its ReLU; ``nn/sr.py``, ``nn/vgg.py``); Adam(2e-4, 0.9, 0.999), HR
256, batch 4.

Schedule (esrgan.py:95-165): the first ``--warmup_batches`` batches train G
on the pixel L1 alone (logged as ``[G pixel: f]``); after them loss_G =
content + lambda_adv * the relativistic-average BCE-with-logits +
lambda_pixel * pixel, with D(real) detached in the G phase, and D trains on
the relativistic real/fake pair. Denormalized previews at
``images/training/<N>.png`` (esrgan.py:186-190). Checkpoints every
``--checkpoint_interval`` batches, named with the epoch (esrgan.py:192-195,
the zoo's one batch-interval checkpoint).

``infer_image`` is test_on_image.py: load a generator ``state_dict`` (the
reference's own ``.pth`` format), normalize the image, upsample 4x,
denormalize, write ``images/outputs/sr-<name>``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from tpugan_torch.io.images import read_rgb, save_image
from tpugan_torch.losses import bce_with_logits, l1
from tpugan_torch.models.srgan import (
    MODULES,
    make_loader,
    maybe_resume,
    nhwc,
    prepare_lr_hr,
    save_checkpoints,
)
from tpugan_torch.nn.sr import ESRGANGenerator, SRDiscriminator
from tpugan_torch.nn.vgg import imagenet_denormalize, imagenet_normalize, vgg_features
from tpugan_torch.ops.image import upsample_nearest
from tpugan_torch.train.loop import StepObserver, train_device
from tpugan_torch.train.state import TrainState
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "esrgan"
VGG_CUT = 35
FILTERS = 64


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with esrgan.py:34-52 and tpugan.models.esrgan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("img_align_celeba", "name of the dataset")
    batch_size: int = flag(4, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.9, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    hr_height: int = flag(256, "high res. image height")
    hr_width: int = flag(256, "high res. image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(100, "interval between saving image samples")
    checkpoint_interval: int = flag(
        5000, "batch interval between model checkpoints"
    )
    residual_blocks: int = flag(23, "number of residual blocks in the generator")
    warmup_batches: int = flag(500, "number of batches with pixel-wise loss only")
    lambda_adv: float = flag(5e-3, "adversarial loss weight")
    lambda_pixel: float = flag(1e-2, "pixel-wise loss weight")


def build(cfg: Config, device) -> dict:
    """The RRDB generator, the discriminator and the frozen VGG features,
    with weights drawn from a generator seeded by ``--seed`` on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {"generator": ESRGANGenerator(cfg.channels, FILTERS, cfg.residual_blocks,
                                            generator=gen),
               "discriminator": SRDiscriminator(cfg.channels, generator=gen)}
    modules = {k: m.to(device) for k, m in modules.items()}
    modules["vgg"] = vgg_features(VGG_CUT, cfg.data_dir, device, generator=gen)
    return modules


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) for the generator and the discriminator."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, {k: adam(modules[k]) for k in MODULES}, draws)


def make_steps(cfg: Config, state: TrainState):
    """``(warmup_step, full_step)``, each ``(state, imgs_u8) -> (state,
    out)``. The warm-up step updates G on the pixel L1 alone (``out``:
    ``loss_pixel``). The full step (esrgan.py:112-165) updates G, then D;
    D's BatchNorm statistics move four times, on the real and the fake batch
    in the G phase and again in the D phase. Its ``out`` holds ``d_loss``,
    ``g_loss``, ``loss_content``, ``loss_GAN``, ``loss_pixel`` (0-d),
    ``imgs_lr`` and ``gen_hr`` (NCHW)."""
    G, D, V = (state.modules[k] for k in ("generator", "discriminator", "vgg"))
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def batch(state, imgs_u8):
        return prepare_lr_hr(imgs_u8.to(state.draws.device, non_blocking=True), cfg.hr_height)

    def warmup_step(state: TrainState, imgs_u8):
        imgs_lr, imgs_hr = batch(state, imgs_u8)
        opt_g.zero_grad(set_to_none=True)
        loss_pixel = l1(G(imgs_lr), imgs_hr)
        loss_pixel.backward()
        opt_g.step()
        state.step += 1
        return state, {"loss_pixel": loss_pixel.detach()}

    def full_step(state: TrainState, imgs_u8):
        imgs_lr, imgs_hr = batch(state, imgs_u8)
        opt_g.zero_grad(set_to_none=True)
        gen_hr = G(imgs_lr)
        loss_pixel = l1(gen_hr, imgs_hr)
        with torch.no_grad():
            pred_real = D(imgs_hr)
            real_features = V(imgs_hr)
        loss_gan = bce_with_logits(D(gen_hr) - pred_real.mean(0, keepdim=True), 1.0)
        loss_content = l1(V(gen_hr), real_features)
        g_loss = loss_content + cfg.lambda_adv * loss_gan + cfg.lambda_pixel * loss_pixel
        g_loss.backward(inputs=g_params)
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        gen_d = gen_hr.detach()
        pred_real, pred_fake = D(imgs_hr), D(gen_d)
        loss_real = bce_with_logits(pred_real - pred_fake.mean(0, keepdim=True), 1.0)
        loss_fake = bce_with_logits(pred_fake - pred_real.mean(0, keepdim=True), 0.0)
        d_loss = (loss_real + loss_fake) / 2
        d_loss.backward()
        opt_d.step()

        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                       "loss_content": loss_content.detach(), "loss_GAN": loss_gan.detach(),
                       "loss_pixel": loss_pixel.detach(), "imgs_lr": imgs_lr, "gen_hr": gen_d}

    return warmup_step, full_step


def save_preview(cfg, out: dict, batches_done: int) -> None:
    """esrgan.py:186-190: the denormalized 4x-nearest LR beside the SR image,
    one row an image, to images/training/<N>.png."""
    lr_up = imagenet_denormalize(upsample_nearest(out["imgs_lr"], 4))
    grid = torch.cat([lr_up, imagenet_denormalize(out["gen_hr"])], dim=3)
    save_image(nhwc(grid), os.path.join(cfg.output_dir, "images", "training",
                                        "%d.png" % batches_done), nrow=1)


def run(cfg: Config, device=None) -> TrainState:
    """Train (``tpugan/models/esrgan.py:run``): the warm-up step for the
    first ``--warmup_batches`` batches (counted from epoch 0), the full step
    after; previews and checkpoints on full-step batches only. ``device``
    None means CUDA, and raises when there is none; the tests pass the CPU.
    On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    os.makedirs(os.path.join(cfg.output_dir, "images", "training"), exist_ok=True)
    maybe_resume(cfg, modules)
    state = create_state(cfg, modules, device)
    loader = make_loader(cfg, device)
    observer = StepObserver(cfg)
    warmup_step, full_step = map(observer.checked, make_steps(cfg, state))
    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    for epoch in range(cfg.epoch, cfg.n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                batches_done = epoch * bpe + i
                logged = cfg.log_interval > 0 and i % cfg.log_interval == 0
                if batches_done < cfg.warmup_batches:
                    state, out = warmup_step(state, *batch)
                    observer.observe(batches_done, out)
                    if logged:
                        print("[Epoch %d/%d] [Batch %d/%d] [G pixel: %f]"
                              % (epoch, cfg.n_epochs, i, bpe, float(out["loss_pixel"])))
                    continue
                state, out = full_step(state, *batch)
                observer.observe(batches_done, out)
                if logged:
                    print("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] "
                          "[G loss: %f, content: %f, adv: %f, pixel: %f]"
                          % (epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]),
                             float(out["g_loss"]), float(out["loss_content"]),
                             float(out["loss_GAN"]), float(out["loss_pixel"])))
                if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                    save_preview(cfg, out, batches_done)
                if cfg.checkpoint_interval > 0 and batches_done % cfg.checkpoint_interval == 0:
                    save_checkpoints(cfg, modules, epoch)
    observer.close()
    return state


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


# --- Inference (esrgan/test_on_image.py) ------------------------------------------------


@dataclasses.dataclass
class TestOnImageConfig(BaseConfig):
    # Flag parity with test_on_image.py:11-16 and tpugan.models.esrgan.
    image_path: str = flag("", "Path to image")
    checkpoint_model: str = flag("", "Path to checkpoint model")
    channels: int = flag(3, "Number of image channels")
    residual_blocks: int = flag(23, "Number of residual blocks in G")


@torch.no_grad()
def infer_image(cfg: TestOnImageConfig, device=None) -> str:
    """test_on_image.py:19-39: load the generator's ``state_dict``,
    normalize the image, upsample it 4x, denormalize, and write
    images/outputs/sr-<name> (``save_image``'s 2 px border kept). ``device``
    None means CUDA, and raises when there is none. Returns the path."""
    if not (cfg.image_path and cfg.checkpoint_model):
        raise ValueError("--image_path and --checkpoint_model are required")
    device = train_device(cfg, device)
    G = ESRGANGenerator(cfg.channels, FILTERS, cfg.residual_blocks)
    G.load_state_dict(torch.load(cfg.checkpoint_model, map_location="cpu", weights_only=True))
    G.to(device).eval()
    img = torch.from_numpy(read_rgb(cfg.image_path).astype(np.float32) / 255.0)
    x = imagenet_normalize(img.permute(2, 0, 1)[None].to(device))
    sr = imagenet_denormalize(G(x))
    path = os.path.join(cfg.output_dir, "images", "outputs",
                        "sr-%s" % os.path.basename(cfg.image_path))
    save_image(nhwc(sr), path, nrow=1)
    return path


def main_test_on_image(argv=None, device=None):
    return infer_image(config_from_args(TestOnImageConfig, argv), device)


if __name__ == "__main__":
    main()
