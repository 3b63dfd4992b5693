"""Context-Conditional GAN (Denton et al. 2016): the port of
``tpugan/models/ccgan.py``.

A 6-down/5-up U-Net G(masked image, low-res image) with bias-free convs and
BatchNorm(eps 0.8), the quarter-resolution image concatenated after d2
(ccgan/models.py:45-80), and context_encoder's discriminator over the whole
128px image (models.py:83-111, patch H/8). MSE adversarial loss only
(ccgan.py:134, 146-148), Adam(2e-4, 0.5, 0.999), batch 8, a 32px mask.

Each training image gets a random square of mask_size filled with -1
(ccgan.py:84-92), placed by ``torch.randint`` on the state's device
generator and applied by index arithmetic on the device; the low-res input
is ``resize_bilinear`` of the full image (antialiased, as
``jax.image.resize``); the generator's dropout masks come from the same
generator. So ``graph_steps`` can capture the step (``--steps_per_dispatch``).
The discriminator's IN runs through the port's instance-norm kernel pair,
inside the CUDA graph when fused.

The sample sheet holds the first image of each of the first ten batches the
log or the sample callback sees (the JAX package's ``_accumulate``, kept as
it is, so under fused dispatch a dispatch's rows all carry its last step's
images): masked over generated over original, 5 a row, to images/<N>.png.
The generator runs in training mode, its dropout masks from a generator of
the sampler's own, its BatchNorm update dropped.

Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/ccgan.py:238``): each
rank loads its rows of every global batch and keeps its rows of the corners
and of the generator's dropout masks, both drawn for the global batch; the
generator's BatchNorms take global statistics, the discriminator's IN
kernel runs on the rank's rows; the losses are global means; rank 0 alone
logs, keeps the preview (the first row of its rows is the global batch's)
and samples, its generator's BatchNorm on the sample batch alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import mse
from tpugan_torch.models._common import sample_generator, save_grid
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.models.context_encoder import (
    CEDiscriminator,
    random_corners,
    square_mask,
)
from tpugan_torch.data.im2im import celeba_images_or_synthetic
from tpugan_torch.data.loader import DeviceLoader
from tpugan_torch.nn.im2im import UNet, UNetDown, UNetUp, _numbered
from tpugan_torch.nn.layers import Conv2d, Upsample, batch_stats_frozen, rank_local
from tpugan_torch.ops.image import resize_bilinear
from tpugan_torch.parallel.mesh import (
    auto_sharding,
    global_batch,
    global_means,
    local_rows,
    rank_zero_write,
    replicate_for,
)
from tpugan_torch.train.loop import Callbacks, run_training, train_device
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "ccgan"
PREVIEW = 10  # the sheet's images: the first of each of the first ten batches


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with ccgan.py:23-35 and tpugan.models.ccgan.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(8, "size of the batches")
    dataset_name: str = flag("img_align_celeba", "name of the dataset")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    img_size: int = flag(128, "size of each image dimension")
    mask_size: int = flag(32, "size of random mask")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(500, "interval between image sampling")


class CCGANGenerator(UNet):
    """ccgan/models.py:45-80: 6 downs and 5 ups, bias-free convs,
    BatchNorm(0.8), dropout 0.5 at d3-d6 and u1-u3 (seven sites), the
    low-res image concatenated after d2, then Upsample, a 3x3 conv and
    tanh."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        kw = dict(norm="batch08", generator=generator)
        downs = [UNetDown(channels, 64, normalize=False, **kw), UNetDown(64, 128, **kw),
                 UNetDown(128 + channels, 256, dropout=0.5, **kw),
                 UNetDown(256, 512, dropout=0.5, **kw), UNetDown(512, 512, dropout=0.5, **kw),
                 UNetDown(512, 512, dropout=0.5, **kw)]
        ups = [UNetUp(512, 512, dropout=0.5, **kw), UNetUp(1024, 512, dropout=0.5, **kw),
               UNetUp(1024, 256, dropout=0.5, **kw), UNetUp(512, 128, **kw),
               UNetUp(256 + channels, 64, **kw)]
        final = _numbered([(Upsample(2), 1),
                           (Conv2d(128, channels, 3, 1, 1, init_mode="normal02",
                                   generator=generator), 1), (nn.Tanh(), 1)])
        super().__init__(downs, ups, final, lowres_at=2)

    def forward(self, x, x_lr, masks=None, generator=None):
        return self.run(x, masks, generator, x_lr)


def build(cfg: Config, device) -> dict:
    """The generator and discriminator with weights drawn from a generator
    seeded by ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {"generator": CCGANGenerator(cfg.channels, generator=gen),
               "discriminator": CEDiscriminator(cfg.channels, generator=gen)}
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, corners=None, masks=None) -> (state, out)``: one
    G update, then one D update (ccgan.py:128-151). ``corners`` (B, 2) are
    the masks' top-left (y, x); ``masks`` the keep masks of the generator's
    seven dropout sites in call order; None draws them from ``state.draws``,
    the corners first, the masks ahead of the forward (``UNet.draw_masks``:
    the bits the forward would draw). D sees the real and the generated
    images in one forward (its norms are per sample). ``out`` holds
    ``d_loss`` and ``g_loss`` (0-d) and the batch's ``imgs``, ``masked``
    and ``lowres`` (NCHW). Under data parallelism (``state.dp``) the draws
    are the global batch's, drawn or passed in, the step keeps this rank's
    rows and the losses in ``out`` are global means. No host sync:
    ``graph_steps`` can capture it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())
    lr_size = (cfg.img_size // 4, cfg.img_size // 4)

    def step(state: TrainState, imgs_u8, corners=None, masks=None):
        device = state.draws.device
        imgs = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        b, dp = imgs.shape[0], state.dp
        imgs_lr = resize_bilinear(imgs, lr_size)
        if corners is None:
            corners = random_corners(cfg, global_batch(dp, b), state.draws)
        if masks is None:
            masks = G.draw_masks(global_batch(dp, b), state.draws, imgs.shape[2:])
        corners, masks = local_rows(dp, corners), [local_rows(dp, m) for m in masks]
        masked = torch.where(square_mask(corners, cfg.img_size, cfg.mask_size), -1.0, imgs)

        opt_g.zero_grad(set_to_none=True)
        gen = G(masked, imgs_lr, masks)
        g_loss = mse(D(gen), 1.0)
        g_loss.backward(inputs=g_params)
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        pred = D(torch.cat([imgs, gen.detach()]))
        d_loss = 0.5 * (mse(pred[:b], 1.0) + mse(pred[b:], 0.0))
        d_loss.backward()
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "imgs": imgs,
               "masked": masked, "lowres": imgs_lr}
        return state, global_means(dp, out, ("d_loss", "g_loss"))

    return step


def make_loader(cfg: Config, device, batch_size=None, prefetch: int = 2, dp=None):
    """CelebA (or the synthetic faces) at ``--img_size``, every image a
    training image; this rank's share of each batch under ``dp``."""
    imgs, is_real = celeba_images_or_synthetic(
        cfg.data_dir, cfg.dataset_name, cfg.img_size, cfg.img_size,
        mode="train", val_tail=0, synthetic=cfg.synthetic_data, seed=cfg.seed,
    )
    if not is_real:
        print("[tpugan] CelebA not found on disk — using synthetic faces")
    return DeviceLoader([imgs], batch_size or cfg.batch_size, device, shuffle=True,
                        seed=cfg.seed, prefetch=prefetch, dp=dp)


class Preview:
    """The sample sheet's images (ccgan.py:103, 158-166): ``add(out,
    batches_done)`` keeps the first image of ``imgs``, ``masked`` and
    ``lowres`` of the first ten distinct steps it is called with, copied
    (a fused dispatch's outputs are overwritten by its next replay)."""

    def __init__(self):
        self.seen = set()
        self.saved = {}

    def add(self, out, batches_done: int) -> None:
        if batches_done in self.seen or len(self.seen) >= PREVIEW:
            return
        self.seen.add(batches_done)
        for k in ("imgs", "masked", "lowres"):
            first = out[k][:1].detach().clone()
            self.saved[k] = torch.cat([self.saved[k], first]) if k in self.saved else first


def make_callbacks(cfg: Config) -> Callbacks:
    """The log line, which also feeds the preview, and the sampler: G on the
    preview's masked and low-res images, in training mode, its dropout
    masks from ``_common.sample_generator`` and its BatchNorm update
    dropped; under data parallelism the sampler, and so the preview it
    adds to, runs on rank 0 alone, its BatchNorm on the sample batch alone
    (``rank_local``)."""
    preview = Preview()
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)

    def log(epoch, i, bpe, out):
        preview.add(out, epoch * bpe + i)
        print("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f]" % (
            epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]), float(out["g_loss"])))

    @torch.no_grad()
    def write(state, out, batches_done):
        preview.add(out, batches_done)
        G = state.modules["generator"]
        p = preview.saved
        draws = sample_generator(cfg, batches_done, p["masked"].device)
        with rank_local(G), batch_stats_frozen(G):
            gen = G(p["masked"], p["lowres"], generator=draws)
        save_grid(torch.cat([p["masked"], gen, p["imgs"]], dim=2),
                  os.path.join(imgdir, "%d.png" % batches_done), 5)

    def sample(state, out, batches_done):
        rank_zero_write(lambda: write(state, out, batches_done))

    return Callbacks(log=log, sample=sample)


def run(cfg: Config, device=None) -> TrainState:
    """Train through ``run_training``: eager, or ``--steps_per_dispatch K``
    steps a CUDA graph. ``device`` None means CUDA, and raises when there is
    none; the tests pass the CPU. On CUDA, float32 means TF32 off. Under a
    launcher of several ranks it runs data-parallel (module docstring)."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, modules, device))
    return run_training(cfg, make_loader(cfg, device, dp=dp), state, make_step(cfg, state),
                        make_callbacks(cfg), n_epochs=cfg.n_epochs,
                        sample_interval=cfg.sample_interval)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
