"""Context Encoder (Pathak et al. 2016), inpainting: the port of
``tpugan/models/context_encoder.py``.

A conv encoder (5 stride-2 downs with BatchNorm eps 0.8) into a 1x1 conv to
a 4000-channel bottleneck and a transposed-conv decoder that emits only the
mask patch (context_encoder/models.py:6-40); a 4-block discriminator on the
patch, IN after all but the first block, strides 2/2/2/1 (models.py:43-66,
patch mask_size/8). Loss 0.001 * MSE adversarial + 0.999 * L1 on the masked
part (context_encoder.py:149-152), at 128px with a 64px mask, batch 8, on
CelebA or the synthetic faces.

Each training image gets a random square of mask_size filled with 1.0 (in
normalized space, datasets.py:20-28); its corner is drawn by ``torch.randint``
on the state's device generator, and the mask and the gather of the masked
part are index arithmetic on the device, so ``graph_steps`` can capture the
step (``--steps_per_dispatch``). The discriminator's IN runs through the
port's instance-norm kernel pair fused with its LeakyReLU(0.2), inside the
CUDA graph when fused. The sampler fills the centre mask with the train-mode
generator, its BatchNorm update dropped as the JAX sampler drops it.

Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/context_encoder.py:274``):
each rank loads its rows of every global batch and keeps its rows of the
corners drawn for the global batch; the generator's BatchNorms take global
statistics, the discriminator's IN kernel runs on the rank's rows; the
losses are global means; rank 0 alone logs and samples, its generator's
BatchNorm on the sample batch alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from tpugan_torch.data.im2im import celeba_images_or_synthetic
from tpugan_torch.data.loader import DeviceLoader
from tpugan_torch.losses import l1, mse
from tpugan_torch.models._common import save_grid
from tpugan_torch.models._im2im_common import first_batch
from tpugan_torch.models._template_b import create_state_b
from tpugan_torch.nn.im2im import _numbered
from tpugan_torch.nn.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    InstanceNorm,
    LeakyReLU,
    batch_stats_frozen,
    rank_local,
)
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

NAME = "context_encoder"


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with context_encoder.py:33-45 and tpugan.models.context_encoder.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(8, "size of the batches")
    dataset_name: str = flag("img_align_celeba", "name of the dataset")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(4, "number of cpu threads to use during batch generation")
    latent_dim: int = flag(100, "dimensionality of the latent space")
    img_size: int = flag(128, "size of each image dimension")
    mask_size: int = flag(64, "size of random mask")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(500, "interval between image sampling")


class CEGenerator(nn.Module):
    """context_encoder/models.py:6-40: downs 64, 64, 128, 256, 512 (Conv
    4/2/1, BatchNorm(0.8) after all but the first, LeakyReLU(0.2)), a 1x1
    conv to 4000 channels, ups 512, 256, 128, 64 (ConvTranspose 4/2/1,
    BatchNorm(0.8), ReLU), a 3x3 conv and tanh; ``normal02`` init."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        bn = lambda f: (BatchNorm2d(f, 0.8, init_mode="normal02", generator=g), 1)
        layers, cin = [], channels
        for i, f in enumerate((64, 64, 128, 256, 512)):
            layers.append((Conv2d(cin, f, 4, 2, 1, init_mode="normal02", generator=g), 1))
            layers += ([bn(f)] if i else []) + [(LeakyReLU(0.2), 1)]
            cin = f
        layers.append((Conv2d(512, 4000, 1, init_mode="normal02", generator=g), 1))
        cin = 4000
        for f in (512, 256, 128, 64):
            layers += [(ConvTranspose2d(cin, f, 4, 2, 1, generator=g), 1), bn(f),
                       (nn.ReLU(), 1)]
            cin = f
        layers += [(Conv2d(64, channels, 3, 1, 1, init_mode="normal02", generator=g), 1),
                   (nn.Tanh(), 1)]
        self.model = _numbered(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class CEDiscriminator(nn.Module):
    """context_encoder/models.py:43-66 (also ccgan's, models.py:83-111): 3x3
    convs of 64, 128, 256, 512 with strides 2, 2, 2, 1, IN after all but the
    first, each followed by LeakyReLU(0.2) (fused with the IN), then a 3x3
    head; ``normal02`` init."""

    def __init__(self, channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers, cin = [], channels
        for f, stride, normalize in ((64, 2, False), (128, 2, True), (256, 2, True),
                                     (512, 1, True)):
            layers.append((Conv2d(cin, f, 3, stride, 1, init_mode="normal02",
                                  generator=generator), 1))
            layers.append((InstanceNorm(act_slope=0.2), 2) if normalize else (LeakyReLU(0.2), 1))
            cin = f
        layers.append((Conv2d(512, 1, 3, 1, 1, init_mode="normal02", generator=generator), 1))
        self.model = _numbered(layers)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)


def build(cfg: Config, device) -> dict:
    """The generator and discriminator with weights drawn from a generator
    seeded by ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {"generator": CEGenerator(cfg.channels, generator=gen),
               "discriminator": CEDiscriminator(cfg.channels, generator=gen)}
    return {k: m.to(device) for k, m in modules.items()}


create_state = create_state_b


def square_mask(corners: torch.Tensor, img_size: int, mask_size: int) -> torch.Tensor:
    """(B, 1, H, W) bool: True inside each image's mask_size square whose top
    left corner is ``corners[b]`` = (y, x); index arithmetic on the device."""
    pos = torch.arange(img_size, device=corners.device)
    inside = (pos >= corners[:, :, None]) & (pos < corners[:, :, None] + mask_size)  # (B, 2, S)
    return (inside[:, 0, :, None] & inside[:, 1, None, :])[:, None]


def crop_squares(imgs: torch.Tensor, corners: torch.Tensor, size: int) -> torch.Tensor:
    """The (B, C, size, size) square of each image at its corner (y, x): a
    gather by index arithmetic on the device."""
    b, c = imgs.shape[:2]
    offs = torch.arange(size, device=imgs.device)
    ys = (corners[:, 0, None] + offs)[:, None, :, None]
    xs = (corners[:, 1, None] + offs)[:, None, None, :]
    return imgs[torch.arange(b, device=imgs.device)[:, None, None, None],
                torch.arange(c, device=imgs.device)[None, :, None, None], ys, xs]


def random_corners(cfg, b: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 2) corners uniform over [0, img_size - mask_size), as
    ``jax.random.randint`` draws them (datasets.py:20-28)."""
    return torch.randint(0, cfg.img_size - cfg.mask_size, (b, 2), generator=generator,
                         device=generator.device)


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_u8, corners=None) -> (state, out)``: one G update,
    then one D update (context_encoder.py:143-169). ``corners`` (B, 2) are
    the masks' top-left (y, x); None draws them from ``state.draws``. D sees
    the real and the generated patches in one forward (its norms are per
    sample). ``out`` holds ``d_loss``, ``g_adv`` and ``g_pixel`` as 0-d
    tensors. Under data parallelism (``state.dp``) the corners are the
    global batch's, drawn or passed in, the step keeps this rank's rows and
    ``out`` holds global means. No host sync: ``graph_steps`` can capture
    it."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())

    def step(state: TrainState, imgs_u8, corners=None):
        device = state.draws.device
        imgs = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        b, dp = imgs.shape[0], state.dp
        if corners is None:
            corners = random_corners(cfg, global_batch(dp, b), state.draws)
        corners = local_rows(dp, corners)
        masked = torch.where(square_mask(corners, cfg.img_size, cfg.mask_size), 1.0, imgs)
        parts = crop_squares(imgs, corners, cfg.mask_size)

        opt_g.zero_grad(set_to_none=True)
        gen_parts = G(masked)
        g_adv = mse(D(gen_parts), 1.0)
        g_pixel = l1(gen_parts, parts)
        (0.001 * g_adv + 0.999 * g_pixel).backward(inputs=g_params)
        opt_g.step()

        opt_d.zero_grad(set_to_none=True)
        pred = D(torch.cat([parts, gen_parts.detach()]))
        d_loss = 0.5 * (mse(pred[:b], 1.0) + mse(pred[b:], 0.0))
        d_loss.backward()
        opt_d.step()

        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_adv": g_adv.detach(), "g_pixel": g_pixel.detach()}
        return state, global_means(dp, out, tuple(out))

    return step


def make_loader(cfg: Config, device, mode: str = "train", batch_size=None, prefetch: int = 2,
                dp=None):
    """CelebA (or the synthetic faces) at ``--img_size``: the training
    images, or with ``mode="val"`` the held-out tail; this rank's share of
    each batch under ``dp``."""
    imgs, is_real = celeba_images_or_synthetic(
        cfg.data_dir, cfg.dataset_name, cfg.img_size, cfg.img_size,
        mode=mode, synthetic=cfg.synthetic_data, seed=cfg.seed,
    )
    if not is_real and mode == "train":
        print("[tpugan] CelebA not found on disk — using synthetic faces")
    return DeviceLoader([imgs], batch_size or cfg.batch_size, device, shuffle=True,
                        seed=cfg.seed if mode == "train" else cfg.seed + 991, prefetch=prefetch,
                        dp=dp)


def make_sampler(cfg: Config, device):
    """context_encoder.py:109-120: 12 validation images with the centre
    mask; each masked over filled over original, 6 a row, to
    images/<N>.png. The train-mode generator (BatchNorm on batch statistics,
    running statistics left alone); under data parallelism on rank 0
    alone, its BatchNorm on the sample batch alone (``rank_local``)."""
    val_loader = make_loader(cfg, device, mode="val", batch_size=12, prefetch=0)
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    i0, m = (cfg.img_size - cfg.mask_size) // 2, cfg.mask_size

    @torch.no_grad()
    def write(state, batches_done):
        G = state.modules["generator"]
        (imgs_u8,) = first_batch(val_loader, batches_done)
        imgs = normalize_uint8(imgs_u8)
        masked = imgs.clone()
        masked[:, :, i0:i0 + m, i0:i0 + m] = 1.0
        with rank_local(G), batch_stats_frozen(G):
            filled = masked.clone()
            filled[:, :, i0:i0 + m, i0:i0 + m] = G(masked)
        save_grid(torch.cat([masked, filled, imgs], dim=2),
                  os.path.join(imgdir, "%d.png" % batches_done), 6)

    def sample(state, out, batches_done):
        rank_zero_write(lambda: write(state, batches_done))

    return sample


def run(cfg: Config, device=None) -> TrainState:
    """Train through ``run_training``: eager, or ``--steps_per_dispatch K``
    steps a CUDA graph. ``device`` None means CUDA, and raises when there is
    none; the tests pass the CPU. On CUDA, float32 means TF32 off. Under a
    launcher of several ranks it runs data-parallel (module docstring)."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, modules, device))

    def log(epoch, i, bpe, out):
        print("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G adv: %f, pixel: %f]" % (
            epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]), float(out["g_adv"]),
            float(out["g_pixel"])))

    return run_training(cfg, make_loader(cfg, device, dp=dp), state, make_step(cfg, state),
                        Callbacks(log=log, sample=make_sampler(cfg, device)),
                        n_epochs=cfg.n_epochs, sample_interval=cfg.sample_interval)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
