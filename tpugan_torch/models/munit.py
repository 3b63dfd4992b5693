"""MUNIT (Huang et al. 2018), multimodal unsupervised image-to-image
translation: the port of ``tpugan/models/munit.py``.

Per domain an encoder (content + style, munit/models.py:33-42) and an AdaIN
decoder (models.py:50-105), plus a three-scale MultiDiscriminator
(models.py:197-235), at 128px on the paired-file layout. G loss
(munit.py:185-232): multi-scale MSE adversarial + 10 * L1 image
reconstruction + 1 * L1 style reconstruction (against the sampled style) +
1 * L1 content reconstruction (against the detached encoder content); the
cycle term has weight 0 in the reference and is not computed. One Adam over
Enc1/Dec1/Enc2/Dec2, one per discriminator, LambdaLR decay from
``--decay_epoch``. Style codes are N(0, 1) of shape (B, style_dim), drawn from
the train state's generator or passed in. Checkpoints are
``Enc1/Dec1/Enc2/Dec2/D1/D2_<epoch>.pth`` (munit.py:283-288).

As in the JAX step, the G phase makes four decoder and four encoder calls
and two discriminator calls, and each D phase two discriminator calls.

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none. Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/munit.py:308-316``):
each rank loads its rows of the global batch, the style codes are drawn for
the global batch from ``state.generator`` and each rank keeps its rows (the
AdaIN pair runs on them), the losses are global means, and rank 0 alone
samples and writes checkpoints. The default batch of 1 does not divide over
the ranks and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tpugan_torch.io.images import save_image
from tpugan_torch.losses import l1
from tpugan_torch.models._common import sample_generator
from tpugan_torch.models._im2im_common import (
    first_batch,
    maybe_resume,
    out_dirs,
    paired_loader,
    run_per_step,
)
from tpugan_torch.nn.style import (
    ContentEncoder,
    MultiDiscriminator,
    MunitDecoder,
    StyleEncoder,
    multi_d_loss,
)
from tpugan_torch.parallel.mesh import (
    DataParallel,
    auto_sharding,
    global_batch,
    global_means,
    local_rows,
    replicate_for,
)
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.optim import linear_decay_lambda
from tpugan_torch.train.state import normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "munit"
MODULES = ("Enc1", "Dec1", "Enc2", "Dec2", "D1", "D2")
LAMBDA_GAN, LAMBDA_ID, LAMBDA_STYLE, LAMBDA_CONT = 1.0, 10.0, 1.0, 1.0


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with munit.py:24-43 and tpugan.models.munit.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("edges2shoes", "name of the dataset")
    batch_size: int = flag(1, "size of the batches")
    lr: float = flag(0.0001, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(128, "size of image height")
    img_width: int = flag(128, "size of image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(400, "interval saving generator samples")
    checkpoint_interval: int = flag(-1, "interval between saving model checkpoints")
    n_downsample: int = flag(2, "number downsampling layers in encoder")
    n_residual: int = flag(3, "number of residual blocks in encoder / decoder")
    dim: int = flag(64, "number of filters in first encoder layer")
    style_dim: int = flag(8, "dimensionality of the style code")


class MunitEncoder(nn.Module):
    """munit/models.py:33-42: (content code, style code)."""

    def __init__(self, in_channels: int, dim: int, n_residual: int, n_downsample: int,
                 style_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.content_encoder = ContentEncoder(in_channels, dim, n_residual, n_downsample,
                                              generator=generator)
        self.style_encoder = StyleEncoder(in_channels, dim, n_downsample, style_dim,
                                          generator=generator)

    def forward(self, x: torch.Tensor):
        return self.content_encoder(x), self.style_encoder(x)


@dataclasses.dataclass
class TrainState:
    """What the step updates: the modules' parameters (through the
    optimizers), the optimizers' moments and the schedulers; ``generator``
    draws the style codes. ``step`` counts optimizer steps; ``dp`` is the
    data-parallel descriptor (``parallel.replicate_for``), None in one
    process."""

    modules: dict
    optimizers: dict
    schedulers: dict
    generator: torch.Generator
    step: int = 0
    dp: Optional[DataParallel] = None


def build(cfg: Config, device) -> dict:
    """Enc1, Dec1, Enc2, Dec2, D1, D2 with weights drawn from a generator
    seeded by ``--seed`` (on the CPU, so the weights do not depend on the
    device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    enc = lambda: MunitEncoder(cfg.channels, cfg.dim, cfg.n_residual, cfg.n_downsample,
                               cfg.style_dim, generator=gen)
    dec = lambda: MunitDecoder(cfg.channels, cfg.dim, cfg.n_residual, cfg.n_downsample,
                               cfg.style_dim, generator=gen)
    d = lambda: MultiDiscriminator(cfg.channels, generator=gen)
    modules = {"Enc1": enc(), "Dec1": dec(), "Enc2": enc(), "Dec2": dec(), "D1": d(), "D2": d()}
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    opts = {
        "G": adam([p for k in MODULES[:4] for p in modules[k].parameters()]),
        "D1": adam(modules["D1"].parameters()),
        "D2": adam(modules["D2"].parameters()),
    }
    decay = linear_decay_lambda(cfg.n_epochs, cfg.decay_epoch, offset=cfg.epoch)
    scheds = {k: torch.optim.lr_scheduler.LambdaLR(o, decay) for k, o in opts.items()}
    return TrainState(modules, opts, scheds, torch.Generator().manual_seed(cfg.seed))


def make_step(cfg: Config, modules: dict, device):
    """``step(state, a_u8, b_u8, styles=None) -> (state, out)``: one G update,
    then one update of D1 and of D2 (munit.py:185-254). ``a_u8``/``b_u8`` are
    NHWC uint8 batches. ``styles`` is (style_1, style_2), each (B,
    style_dim); None draws them, in that order, from ``state.generator``.
    Under data parallelism (``state.dp``) they are the global batch's, drawn
    or passed in, and the step keeps this rank's rows. ``out`` holds
    ``d_loss`` and ``g_loss`` as 0-d tensors (global means). After the step
    each parameter's ``.grad`` holds the gradient it was updated with."""
    Enc1, Dec1, Enc2, Dec2, D1, D2 = (modules[k] for k in MODULES)
    g_params = [p for k in MODULES[:4] for p in modules[k].parameters()]
    device = torch.device(device)

    def d_update(state, name, D, real, fake):
        opt = state.optimizers[name]
        opt.zero_grad(set_to_none=True)
        loss = multi_d_loss(D(real), 1.0) + multi_d_loss(D(fake), 0.0)
        loss.backward()
        opt.step()
        return loss.detach()

    def step(state: TrainState, a_u8, b_u8, styles=None):
        x1 = normalize_uint8(a_u8.to(device, non_blocking=True))
        x2 = normalize_uint8(b_u8.to(device, non_blocking=True))
        dp = state.dp
        if styles is None:
            shape = (global_batch(dp, x1.shape[0]), cfg.style_dim)
            styles = [torch.randn(shape, generator=state.generator) for _ in range(2)]
        style_1, style_2 = (local_rows(dp, s).to(device) for s in styles)

        # G phase. Only the encoders' and decoders' parameters take
        # gradients; the discriminators are applied but not updated here.
        opt_g = state.optimizers["G"]
        opt_g.zero_grad(set_to_none=True)
        c1, s1 = Enc1(x1)
        c2, s2 = Enc2(x2)
        x11 = Dec1(c1, s1)
        x22 = Dec2(c2, s2)
        x21 = Dec1(c2, style_1)
        x12 = Dec2(c1, style_2)
        c21, s21 = Enc1(x21)
        c12, s12 = Enc2(x12)
        g_loss = (
            LAMBDA_GAN * multi_d_loss(D1(x21), 1.0)
            + LAMBDA_GAN * multi_d_loss(D2(x12), 1.0)
            + LAMBDA_ID * l1(x11, x1)
            + LAMBDA_ID * l1(x22, x2)
            + LAMBDA_STYLE * l1(s21, style_1)
            + LAMBDA_STYLE * l1(s12, style_2)
            + LAMBDA_CONT * l1(c12, c1.detach())
            + LAMBDA_CONT * l1(c21, c2.detach())
        )
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phases on [real, detached translation] (munit.py:238-254).
        loss_d1 = d_update(state, "D1", D1, x1, x21.detach())
        loss_d2 = d_update(state, "D2", D2, x2, x12.detach())

        state.step += 1
        out = {"d_loss": loss_d1 + loss_d2, "g_loss": g_loss.detach()}
        return state, global_means(dp, out, tuple(out))

    return step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2,
                dp=None):
    return paired_loader(cfg, device, cfg.img_height, cfg.img_width, split, batch_size, prefetch,
                         dp=dp)


def make_sampler(cfg: Config, modules: dict, device):
    """munit.py:139-158: for each of five validation A images, a row of the
    image and its ``style_dim`` translations by Dec2 with U(-1, 1) style
    codes; rows stacked, to images/<dataset>/<N>.png. One batched
    encoder/decoder call over all translations, as the JAX sampler makes.
    The codes come from a generator of the sampler's own, seeded from
    (``--seed``, batches_done) as the JAX sampler folds batches_done into its
    key (``tpugan/models/munit.py:295``): sampling leaves ``state.generator``,
    and so the training draws, as they were."""
    Enc1, Dec2 = modules["Enc1"], modules["Dec2"]
    val_loader = make_loader(cfg, device, split="val", batch_size=5, prefetch=0)
    imgdir, _ = out_dirs(cfg)
    s = cfg.style_dim

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, _ = first_batch(val_loader, batches_done)
        x = normalize_uint8(a_u8)
        n, c, h, w = x.shape
        draws = sample_generator(cfg, batches_done, "cpu")
        codes = (torch.rand((n * s, s), generator=draws) * 2 - 1).to(x.device)
        x12 = Dec2(Enc1.content_encoder(x.repeat_interleave(s, dim=0)), codes)
        rows = torch.cat([x[:, None], x12.reshape(n, s, c, h, w)], dim=1)
        sheet = rows.permute(0, 3, 1, 4, 2).reshape(n * h, (s + 1) * w, c)
        save_image(sheet.float().cpu().numpy()[None], "%s/%s.png" % (imgdir, batches_done),
                   nrow=1, normalize=True)

    return sample


def run(cfg: Config, device=None) -> TrainState:
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off for convolutions and
    matmuls."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    maybe_resume(modules, cfg, MODULES)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, modules, device))
    return run_per_step(
        cfg, make_loader(cfg, device, dp=dp), state, make_step(cfg, modules, device),
        make_sampler(cfg, modules, device),
        lambda out: "[D loss: %f] [G loss: %f]" % (float(out["d_loss"]), float(out["g_loss"])),
        modules, MODULES, epoch_end=lambda: [s.step() for s in state.schedulers.values()])


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
