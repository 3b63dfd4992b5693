"""SRGAN (Ledig et al. 2017), 4x photo-realistic super-resolution: the port
of ``tpugan/models/srgan.py``.

The SRResNet generator (16 residual blocks, two PixelShuffle 2x stages), the
8-conv discriminator and the VGG19 features[:18] content loss
(``nn/sr.py``, ``nn/vgg.py``); loss_G = content L1 + 1e-3 * MSE adversarial,
loss_D the MSE real/fake pair halved (srgan.py:108-145); torch's default
init; Adam(2e-4, 0.5, 0.999) for each, at HR 256, batch 4.

Data: one CelebA image (or a synthetic face) per sample, bicubically
resized on the device from the uint8 HR batch to (H/4, H/4) and (H, H): the
reference takes ``hr_height`` for both sides (datasets.py:29,36), a quirk
kept; then the ImageNet normalization. Samples: [4x-nearest LR | SR]
columns at ``images/<N>.png`` (srgan.py:157-163). Checkpoints each
``--checkpoint_interval`` epochs at ``saved_models/generator_<E>.pth`` and
``discriminator_<E>.pth``; ``--epoch N`` resumes from them (the reference's
resume paths lack their ``% epoch``, srgan.py:77-78: formatted here, as in
the JAX package).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from tpugan_torch.data.im2im import celeba_images_or_synthetic
from tpugan_torch.data.loader import DeviceLoader
from tpugan_torch.io.checkpoint import load_modules, save_modules
from tpugan_torch.io.images import make_grid, save_image
from tpugan_torch.losses import l1, mse
from tpugan_torch.nn.sr import SRDiscriminator, SRGANGenerator
from tpugan_torch.nn.vgg import imagenet_normalize, vgg_features
from tpugan_torch.ops.image import resize_bicubic, upsample_nearest
from tpugan_torch.train.loop import StepObserver, train_device
from tpugan_torch.train.state import TrainState
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "srgan"
MODULES = ("generator", "discriminator")
VGG_CUT = 18


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with srgan.py:34-48 and tpugan.models.srgan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("img_align_celeba", "name of the dataset")
    batch_size: int = flag(4, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    hr_height: int = flag(256, "high res. image height")
    hr_width: int = flag(256, "high res. image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(100, "interval between saving image samples")
    checkpoint_interval: int = flag(-1, "interval between model checkpoints")


def build(cfg: Config, device) -> dict:
    """The generator, the discriminator and the frozen VGG features, with
    weights drawn from a generator seeded by ``--seed`` (on the CPU, so they
    do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {"generator": SRGANGenerator(cfg.channels, generator=gen),
               "discriminator": SRDiscriminator(cfg.channels, generator=gen)}
    modules = {k: m.to(device) for k, m in modules.items()}
    modules["vgg"] = vgg_features(VGG_CUT, cfg.data_dir, device, generator=gen)
    return modules


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) for the generator and the discriminator; the VGG
    features take no step. The steps draw nothing."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, {k: adam(modules[k]) for k in MODULES}, draws)


def prepare_lr_hr(imgs_u8: torch.Tensor, hr_size: int):
    """The dataset's dual transform on the device (srgan/datasets.py:27-40):
    NHWC uint8 to [0, 1], bicubic to (H/4, H/4) and (H, H), then the
    ImageNet normalization; NCHW float32 out."""
    x01 = imgs_u8.permute(0, 3, 1, 2).float().contiguous() / 255.0
    hr = resize_bicubic(x01, (hr_size, hr_size))
    lr = resize_bicubic(x01, (hr_size // 4, hr_size // 4))
    return imagenet_normalize(lr), imagenet_normalize(hr)


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8) -> (state, out)``: ``prepare_lr_hr`` on the
    batch, then ``make_step_pairs``' step."""
    inner = make_step_pairs(cfg, state)

    def step(state: TrainState, imgs_u8):
        imgs_u8 = imgs_u8.to(state.draws.device, non_blocking=True)
        return inner(state, *prepare_lr_hr(imgs_u8, cfg.hr_height))

    return step


def make_step_pairs(cfg: Config, state: TrainState):
    """``step(state, imgs_lr, imgs_hr) -> (state, out)`` over an
    ImageNet-normalized (LR, HR) pair: one G update, then one D update
    (srgan.py:108-145). D's BatchNorm statistics move three times, on the
    fake in the G phase, then on the real and the fake batch. ``out`` holds
    ``d_loss`` and ``g_loss`` (0-d), ``imgs_lr`` and ``gen_hr`` (NCHW)."""
    G, D, V = (state.modules[k] for k in ("generator", "discriminator", "vgg"))
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs_lr, imgs_hr):
        opt_g.zero_grad(set_to_none=True)
        gen_hr = G(imgs_lr)
        loss_gan = mse(D(gen_hr), 1.0)
        with torch.no_grad():
            real_features = V(imgs_hr)
        loss_content = l1(V(gen_hr), real_features)
        g_loss = loss_content + 1e-3 * loss_gan
        g_loss.backward(inputs=g_params)
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        gen_d = gen_hr.detach()
        d_loss = (mse(D(imgs_hr), 1.0) + mse(D(gen_d), 0.0)) / 2
        d_loss.backward()
        opt_d.step()

        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                       "imgs_lr": imgs_lr, "gen_hr": gen_d}

    return step


def make_loader(cfg, device, batch_size=None, prefetch: int = 2) -> DeviceLoader:
    """CelebA images at (hr_height, hr_height), every one of them a training
    image, or the synthetic faces (``tpugan/models/srgan.py:make_loader``)."""
    imgs, is_real = celeba_images_or_synthetic(
        cfg.data_dir, cfg.dataset_name, cfg.hr_height, cfg.hr_height,
        mode="train", val_tail=0, synthetic=cfg.synthetic_data, seed=cfg.seed,
    )
    if not is_real:
        print("[tpugan] CelebA not found on disk — using synthetic faces")
    return DeviceLoader([imgs], batch_size or cfg.batch_size, device, shuffle=True,
                        seed=cfg.seed, prefetch=prefetch)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).float().cpu().numpy()


def save_sr_sample(cfg, out: dict, batches_done: int) -> None:
    """srgan.py:157-163: the 4x-nearest LR and the SR batch, each a column
    normalized over its batch, side by side, to images/<N>.png."""
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    g1 = make_grid(nhwc(upsample_nearest(out["imgs_lr"], 4)), nrow=1, normalize=True)
    g2 = make_grid(nhwc(out["gen_hr"]), nrow=1, normalize=True)
    save_image(np.concatenate([g1, g2], axis=1)[None],
               os.path.join(imgdir, "%d.png" % batches_done), nrow=1, padding=0)


def save_checkpoints(cfg, modules: dict, epoch: int) -> None:
    """``generator_<E>.pth`` and ``discriminator_<E>.pth`` (state_dicts, each
    written to a temporary file and renamed) under saved_models/."""
    save_modules(modules, os.path.join(cfg.output_dir, "saved_models"), epoch, MODULES)


def maybe_resume(cfg, modules: dict) -> None:
    """``--epoch N``: load the generator and the discriminator of epoch N."""
    if cfg.epoch != 0:
        load_modules(modules, os.path.join(cfg.output_dir, "saved_models"), cfg.epoch, MODULES)


def run(cfg: Config, device=None) -> TrainState:
    """Train (``tpugan/models/srgan.py:run``): one step a batch, up to
    ``--max_batches`` an epoch, from ``--epoch``; the reference's line
    without a newline every ``--log_interval`` batches, a sample every
    ``--sample_interval``, checkpoints every ``--checkpoint_interval``
    epochs. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    maybe_resume(cfg, modules)
    state = create_state(cfg, modules, device)
    loader = make_loader(cfg, device)
    observer = StepObserver(cfg)
    step = observer.checked(make_step(cfg, state))
    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    for epoch in range(cfg.epoch, cfg.n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                state, out = step(state, *batch)
                if cfg.log_interval > 0 and i % cfg.log_interval == 0:
                    sys.stdout.write("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f]" % (
                        epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]),
                        float(out["g_loss"])))
                    sys.stdout.flush()
                batches_done = epoch * bpe + i
                observer.observe(batches_done, out)
                if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                    save_sr_sample(cfg, out, batches_done)
        if cfg.checkpoint_interval != -1 and epoch % cfg.checkpoint_interval == 0:
            save_checkpoints(cfg, modules, epoch)
    observer.close()
    return state


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
