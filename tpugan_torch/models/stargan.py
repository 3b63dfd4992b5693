"""StarGAN (Choi et al. 2018), multi-domain attribute translation: the port
of ``tpugan/models/stargan.py``.

A ResNet generator over the image concatenated with the target attributes,
broadcast to its height and width, with affine InstanceNorm that tracks
running statistics (stargan/models.py:17-79), and a discriminator of six
stride-2 convs with LeakyReLU(0.01), a 3x3 PatchGAN head and an attribute
head whose kernel covers the whole map (models.py:87-115), at 128px on
CelebA with ``--selected_attrs``. Losses (stargan.py:72-83, 218-264):
WGAN-GP (lambda 10) plus the attribute loss, BCE-with-logits summed over the
batch's elements and divided by the batch (lambda 1); the generator also
takes 10 * the L1 of the reconstruction from the translation back to the
original attributes. D trains every batch, G every ``n_critic``-th, both on
the same sampled attributes. ``weights_init_normal`` touches only the conv
weights (models.py:6-9): N(0, 0.02), biases and the IN affine at torch's
defaults.

Every IN of the generator is ``InstanceNorm(affine=True,
track_running_stats=True)`` (models.py:23): the kernel pair at slope 1, the
affine, then ReLU as a layer of its own. In training the running buffers
advance once a generator forward, as torch's do: once in a d_step, twice in
a g_step. The sampler's forward leaves them as they were, as the JAX
sampler drops that update (``tpugan/models/stargan.py:375-381``).

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none. Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/stargan.py:426-428``):
each rank loads its rows of the global (image, attributes) batch; the
sampled attributes and the penalty's alphas are drawn for the global batch
and each rank keeps its rows; the running buffers move by the global
batch's means, so they stay equal on every rank; the losses are global
means, and rank 0 alone logs, samples and writes checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
import time
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.io.images import save_image
from tpugan_torch.losses import l1
from tpugan_torch.models._im2im_common import checkpoint_epoch, first_batch, maybe_resume
from tpugan_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    InstanceNorm,
    LeakyReLU,
    batch_stats_frozen,
)
from tpugan_torch.ops.penalty import wgan_gp_penalty
from tpugan_torch.parallel.mesh import (
    auto_sharding,
    global_batch,
    global_means,
    is_writer,
    local_rows,
    rank_zero_write,
    replicate_for,
)
from tpugan_torch.train.loop import StepObserver, train_device
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "stargan"
MODULES = ("generator", "discriminator")
LAMBDA_CLS, LAMBDA_REC, LAMBDA_GP = 1.0, 10.0, 10.0  # stargan.py:81-83


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with stargan.py:40-64 and tpugan.models.stargan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("img_align_celeba", "name of the dataset")
    batch_size: int = flag(16, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(128, "size of image height")
    img_width: int = flag(128, "size of image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(400, "interval between saving generator samples")
    checkpoint_interval: int = flag(-1, "interval between model checkpoints")
    residual_blocks: int = flag(6, "number of residual blocks in generator")
    selected_attrs: List[str] = flag(
        ["Black_Hair", "Blond_Hair", "Brown_Hair", "Male", "Young"],
        "selected attributes for the CelebA dataset",
        short="--list",  # stargan.py:56-62 exposes both spellings
    )
    n_critic: int = flag(5, "number of training iterations for WGAN discriminator")


def _tracked_in(features: int) -> InstanceNorm:
    # models.py:23: InstanceNorm2d(features, affine=True, track_running_stats=True).
    return InstanceNorm(features, affine=True, track_running_stats=True)


def _conv(i, o, k, s, p, gen, bias=False):
    return Conv2d(i, o, k, s, p, bias=bias, init_mode="normal02", generator=gen)


class ResidualBlock(nn.Module):
    """models.py:17-32: Conv3 (no bias), tracked affine IN, ReLU, Conv3, IN,
    with an identity skip."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        f, g = features, generator
        self.conv_block = nn.Sequential(_conv(f, f, 3, 1, 1, g), _tracked_in(f), nn.ReLU(),
                                        _conv(f, f, 3, 1, 1, g), _tracked_in(f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class StarGenerator(nn.Module):
    """models.py:35-79: c7s1-64 over [image; attributes], two stride-2 downs,
    ``res_blocks`` residual blocks, two transposed-conv ups, c7s1-C (with
    bias) and tanh, registered as the reference's ``model``."""

    def __init__(self, channels: int, c_dim: int, res_blocks: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        layers = [_conv(channels + c_dim, 64, 7, 1, 3, g), _tracked_in(64), nn.ReLU()]
        dim = 64
        for _ in range(2):
            layers += [_conv(dim, dim * 2, 4, 2, 1, g), _tracked_in(dim * 2), nn.ReLU()]
            dim *= 2
        layers += [ResidualBlock(dim, g) for _ in range(res_blocks)]
        for _ in range(2):
            layers += [ConvTranspose2d(dim, dim // 2, 4, 2, 1, bias=False, generator=g),
                       _tracked_in(dim // 2), nn.ReLU()]
            dim //= 2
        layers += [_conv(dim, channels, 7, 1, 3, g, bias=True), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        cmap = c[:, :, None, None].expand(-1, -1, x.shape[2], x.shape[3])
        return self.model(torch.cat([x, cmap], dim=1))


class StarDiscriminator(nn.Module):
    """models.py:87-115: six stride-2 4x4 convs with LeakyReLU(0.01), then
    ``out1``, a bias-free 3x3 PatchGAN head, and ``out2``, a bias-free conv
    over the whole img_size // 64 map to the attributes. Returns (out_adv,
    out_cls flattened to (B, c_dim))."""

    def __init__(self, img_size: int, c_dim: int, channels: int = 3, n_strided: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        layers, dim = [], channels
        for i in range(n_strided):
            out = 64 * 2 ** i
            layers += [_conv(dim, out, 4, 2, 1, g, bias=True), LeakyReLU(0.01)]
            dim = out
        self.model = nn.Sequential(*layers)
        self.out1 = _conv(dim, 1, 3, 1, 1, g)
        self.out2 = _conv(dim, c_dim, img_size // 2 ** n_strided, 1, 0, g)

    def forward(self, img: torch.Tensor):
        feat = self.model(img)
        out_cls = self.out2(feat)
        return self.out1(feat), out_cls.reshape(out_cls.shape[0], -1)


def criterion_cls(logit: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits summed over all elements and divided by the batch
    (stargan.py:76-77, the deprecated ``size_average=False``)."""
    return F.binary_cross_entropy_with_logits(logit, target, reduction="sum") / logit.shape[0]


def build(cfg: Config, device) -> dict:
    """The generator and discriminator, weights drawn from a generator seeded
    by ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    c_dim = len(cfg.selected_attrs)
    modules = {
        "generator": StarGenerator(cfg.channels, c_dim, cfg.residual_blocks, generator=gen),
        "discriminator": StarDiscriminator(cfg.img_height, c_dim, cfg.channels, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam for each network, and a device generator of the draws seeded by
    ``--seed``."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    opts = {k: adam(modules[k]) for k in MODULES}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, opts, draws)


def make_steps(cfg: Config, state: TrainState):
    """``(d_step, g_step)``: D every batch, G every ``n_critic``-th, both on
    the same sampled attributes (stargan.py:218-264).

    ``d_step(state, imgs_u8, labels, sampled_c=None, alpha=None)``: the
    generator's forward on ``sampled_c`` (which advances its IN buffers),
    then one D update on WGAN-GP plus the attribute loss of the real batch.
    ``sampled_c`` is (B, c_dim) of 0/1 floats and ``alpha`` the penalty's
    (B, 1, 1, 1); None draws them from ``state.draws`` in that order. Under
    data parallelism (``state.dp``) both are the global batch's, drawn or
    passed in, and the step keeps this rank's rows. ``out`` holds
    ``d_adv``, ``d_cls``, ``d_loss`` (global means) and ``sampled_c``, this
    rank's rows, which the g_step takes.
    ``g_step(state, imgs_u8, labels, sampled_c)``: the translation to
    ``sampled_c`` and back to ``labels`` (two forwards, two buffer
    advances) and one G update; ``out`` holds ``g_loss``, ``g_adv``,
    ``g_cls`` and ``g_rec`` (global means). ``imgs_u8`` is NHWC uint8,
    ``labels`` (B, c_dim) float, this rank's rows under data parallelism."""
    G, D = state.modules["generator"], state.modules["discriminator"]
    opt_g, opt_d = state.optimizers["generator"], state.optimizers["discriminator"]
    g_params = list(G.parameters())
    c_dim = len(cfg.selected_attrs)

    def d_step(state: TrainState, imgs_u8, labels, sampled_c=None, alpha=None):
        device = state.draws.device
        imgs = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        labels = labels.to(device, non_blocking=True).float()
        dp = state.dp
        b = global_batch(dp, imgs.shape[0])
        if sampled_c is None:
            sampled_c = torch.randint(0, 2, (b, c_dim), generator=state.draws,
                                      device=device).float()
        sampled_c = local_rows(dp, sampled_c.to(device))
        with torch.no_grad():
            fake = G(imgs, sampled_c)
        if alpha is None:
            alpha = torch.rand((b, 1, 1, 1), generator=state.draws, device=device)
        alpha = local_rows(dp, alpha)
        opt_d.zero_grad(set_to_none=True)
        real_validity, pred_cls = D(imgs)
        fake_validity, _ = D(fake)
        gp = wgan_gp_penalty(lambda x: D(x)[0], imgs, fake, alpha)
        d_adv = (-torch.mean(real_validity.float()) + torch.mean(fake_validity.float())
                 + LAMBDA_GP * gp)
        d_cls = criterion_cls(pred_cls, labels)
        d_loss = d_adv + LAMBDA_CLS * d_cls
        d_loss.backward()
        opt_d.step()
        state.step += 1
        out = {"d_adv": d_adv.detach(), "d_cls": d_cls.detach(), "d_loss": d_loss.detach(),
               "sampled_c": sampled_c}
        return state, global_means(dp, out, ("d_adv", "d_cls", "d_loss"))

    def g_step(state: TrainState, imgs_u8, labels, sampled_c):
        device = state.draws.device
        imgs = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        labels = labels.to(device, non_blocking=True).float()
        opt_g.zero_grad(set_to_none=True)
        gen_imgs = G(imgs, sampled_c)
        recov_imgs = G(gen_imgs, labels)
        fake_validity, pred_cls = D(gen_imgs)
        g_adv = -torch.mean(fake_validity.float())
        g_cls = criterion_cls(pred_cls, sampled_c)
        g_rec = l1(recov_imgs, imgs)
        g_loss = g_adv + LAMBDA_CLS * g_cls + LAMBDA_REC * g_rec
        g_loss.backward(inputs=g_params)
        opt_g.step()
        out = {"g_loss": g_loss.detach(), "g_adv": g_adv.detach(), "g_cls": g_cls.detach(),
               "g_rec": g_rec.detach()}
        return state, global_means(state.dp, out, tuple(out))

    return d_step, g_step


def make_loader(cfg: Config, device, mode: str = "train", batch_size=None, prefetch: int = 2,
                dp=None):
    """CelebA images and the selected attributes (or the synthetic faces),
    shuffled; the training split with the CycleGAN jitter on the images, the
    val split with seed + 991. Under ``dp`` each batch is this rank's rows
    of the global one, images and attributes alike."""
    from tpugan_torch.data.im2im import celeba_or_synthetic, resize_crop_flip_transform
    from tpugan_torch.data.loader import DeviceLoader

    imgs, labels, is_real = celeba_or_synthetic(
        cfg.data_dir, cfg.dataset_name, cfg.img_height, cfg.img_width, cfg.selected_attrs,
        mode=mode, synthetic=cfg.synthetic_data, seed=cfg.seed)
    if not is_real and mode == "train":
        print("[tpugan] CelebA not found on disk — using synthetic attr faces")
    transform = (resize_crop_flip_transform(cfg.seed, cfg.img_height, cfg.img_width, indices=(0,))
                 if mode == "train" else None)
    return DeviceLoader([imgs, labels], batch_size or cfg.batch_size, device, shuffle=True,
                        seed=cfg.seed if mode == "train" else cfg.seed + 991, prefetch=prefetch,
                        host_transform=transform, dp=dp)


# stargan.py:164-170: the translation sheet of the default five attributes,
# (column, value) changes per translation; -1 flips the attribute.
LABEL_CHANGES = [
    ((0, 1), (1, 0), (2, 0)),
    ((0, 0), (1, 1), (2, 0)),
    ((0, 0), (1, 0), (2, 1)),
    ((3, -1),),
    ((4, -1),),
]


def translation_labels(labels: torch.Tensor, c_dim: int) -> torch.Tensor:
    """(n * c_dim, c_dim): each image's labels once a translation of
    ``LABEL_CHANGES`` (its first c_dim rows, columns below c_dim)."""
    n = labels.shape[0]
    lab = labels.repeat_interleave(c_dim, dim=0).reshape(n, c_dim, c_dim).clone()
    for i, changes in enumerate(LABEL_CHANGES[:c_dim]):
        for col, val in changes:
            if col < c_dim:
                lab[:, i, col] = 1.0 - lab[:, i, col] if val == -1 else float(val)
    return lab.reshape(n * c_dim, c_dim)


def make_sampler(cfg: Config, modules: dict, device):
    """stargan.py:173-197: ten validation images, each a row of the image and
    its c_dim translations, to images/<N>.png. One batched generator call
    over all n * c_dim translations, as the JAX sampler makes, in training
    mode (the reference never calls ``.eval()``) with the IN buffers frozen:
    the JAX sampler drops the advance."""
    G = modules["generator"]
    c_dim = len(cfg.selected_attrs)
    val_loader = make_loader(cfg, device, mode="val", batch_size=10, prefetch=0)
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)

    @torch.no_grad()
    def sample(state, out, batches_done):
        imgs_u8, labels = first_batch(val_loader, batches_done)
        x = normalize_uint8(imgs_u8)
        n, c, h, w = x.shape
        with batch_stats_frozen(G):
            gen = G(x.repeat_interleave(c_dim, dim=0), translation_labels(labels.float(), c_dim))
        rows = torch.cat([x[:, None], gen.reshape(n, c_dim, c, h, w)], dim=1)
        sheet = rows.permute(0, 3, 1, 4, 2).reshape(n * h, (c_dim + 1) * w, c)
        save_image(sheet.float().cpu().numpy()[None], os.path.join(imgdir, "%s.png" % batches_done),
                   nrow=1, normalize=True, padding=2)

    return sample


def run(cfg: Config, device=None) -> TrainState:
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off. The loop of
    ``tpugan/models/stargan.py:run``: a D step every batch; on every
    ``n_critic``-th a G step, the log line and, every ``sample_interval``
    batches, a sample sheet; checkpoints in ``saved_models/`` itself
    (stargan.py:297-300), ``--epoch N`` resuming from them. Under data
    parallelism rank 0 alone logs, samples and writes checkpoints."""
    device = train_device(cfg, device)
    ckpt_cfg = dataclasses.replace(cfg, dataset_name="")  # saved_models/<name>_<epoch>.pth
    modules = build(cfg, device)
    maybe_resume(modules, ckpt_cfg, MODULES)
    dp = auto_sharding(cfg.batch_size, device)
    loader = make_loader(cfg, device, dp=dp)
    state = replicate_for(dp, create_state(cfg, modules, device))
    observer = StepObserver(cfg)
    d_step, g_step = map(observer.checked, make_steps(cfg, state))
    sample = make_sampler(cfg, modules, device)

    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    start_time = time.time()
    writer = is_writer()
    for epoch in range(cfg.epoch, cfg.n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                state, d_out = d_step(state, *batch)
                batches_done = epoch * bpe + i
                if i % cfg.n_critic != 0:
                    observer.observe(batches_done, d_out)
                    continue
                state, g_out = g_step(state, *batch, d_out["sampled_c"])
                observer.observe(batches_done, {**d_out, **g_out})
                if writer and cfg.log_interval > 0:
                    batches_left = cfg.n_epochs * bpe - batches_done
                    time_left = datetime.timedelta(
                        seconds=batches_left * (time.time() - start_time) / (batches_done + 1))
                    sys.stdout.write(
                        "\r[Epoch %d/%d] [Batch %d/%d] [D adv: %f, aux: %f] "
                        "[G loss: %f, adv: %f, aux: %f, cycle: %f] ETA: %s"
                        % (epoch, cfg.n_epochs, i, bpe, float(d_out["d_adv"]),
                           float(d_out["d_cls"]), float(g_out["g_loss"]), float(g_out["g_adv"]),
                           float(g_out["g_cls"]), float(g_out["g_rec"]), time_left))
                    sys.stdout.flush()
                if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                    rank_zero_write(lambda: sample(state, d_out, batches_done))
        checkpoint_epoch(modules, ckpt_cfg, epoch, MODULES)
    observer.close()
    return state


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
