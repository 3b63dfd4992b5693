"""CycleGAN (Zhu et al. 2017), unpaired image-to-image translation: the port
of ``tpugan/models/cyclegan.py``.

Two ResNet generators and two PatchGAN discriminators; MSE GAN loss, cycle L1
weighted ``lambda_cyc`` and identity L1 weighted ``lambda_id``; one Adam over
both generators and one per discriminator, with LambdaLR linear decay from
``--decay_epoch`` stepped once per epoch; 50-image replay buffers feeding the
discriminator updates (reference cyclegan/cyclegan.py, models.py, utils.py).

As in the JAX step, each generator's adversarial and identity applications
run as one batched forward (G_AB on [real_a; real_b]) and each
discriminator sees [real; replayed fake] in one forward: every norm here is
per-sample instance norm, so batching changes no value.

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none. Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/cyclegan.py:292-300``):
each rank steps on its share of the batch, the replay buffers take the
gathered global fakes with the same draws on every rank, so they stay
identical, and each rank keeps its rows of what they return.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpugan_torch.data.im2im import resize_crop_flip_transform, unpaired_or_synthetic
from tpugan_torch.data.loader import UnpairedLoader
from tpugan_torch.io.images import make_grid, save_image
from tpugan_torch.losses import l1, mse
from tpugan_torch.models._im2im_common import first_batch, maybe_resume, out_dirs, run_per_step
from tpugan_torch.nn.im2im import GeneratorResNet, PatchGAN
from tpugan_torch.parallel.mesh import (
    DataParallel,
    auto_sharding,
    gather_rows,
    global_means,
    local_rows,
    replicate_for,
)
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.optim import linear_decay_lambda
from tpugan_torch.train.replay import ReplayBuffer
from tpugan_torch.train.state import normalize_uint8
from tpugan_torch.utils import tracing
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "cyclegan"
MODULES = ("G_AB", "G_BA", "D_A", "D_B")


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with cyclegan.py:24-42 and tpugan.models.cyclegan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("monet2photo", "name of the dataset")
    batch_size: int = flag(1, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(256, "size of image height")
    img_width: int = flag(256, "size of image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(100, "interval between saving generator outputs")
    checkpoint_interval: int = flag(-1, "interval between saving model checkpoints")
    n_residual_blocks: int = flag(9, "number of residual blocks in generator")
    lambda_cyc: float = flag(10.0, "cycle loss weight")
    lambda_id: float = flag(5.0, "identity loss weight")


@dataclasses.dataclass
class TrainState:
    """What the step updates: the modules' parameters (through the
    optimizers), the optimizers' moments, the schedulers and the replay
    buffers. ``step`` counts optimizer steps; ``dp`` is the data-parallel
    descriptor (``parallel.replicate_for``), None in one process."""

    modules: dict
    optimizers: dict
    schedulers: dict
    buffers: dict
    step: int = 0
    dp: Optional[DataParallel] = None


def build(cfg: Config, device) -> dict:
    """G_AB, G_BA, D_A, D_B with weights drawn from a generator seeded by
    ``--seed`` (on the CPU, so the weights do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    g = lambda: GeneratorResNet(cfg.channels, cfg.n_residual_blocks, generator=gen)
    d = lambda: PatchGAN(cfg.channels, head_bias=True, generator=gen)
    modules = {"G_AB": g(), "G_BA": g(), "D_A": d(), "D_B": d()}
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    opts = {
        "G": adam([*modules["G_AB"].parameters(), *modules["G_BA"].parameters()]),
        "D_A": adam(modules["D_A"].parameters()),
        "D_B": adam(modules["D_B"].parameters()),
    }
    # LambdaLR decay, offset by the start epoch (cyclegan.py:94-102).
    decay = linear_decay_lambda(cfg.n_epochs, cfg.decay_epoch, offset=cfg.epoch)
    scheds = {k: torch.optim.lr_scheduler.LambdaLR(o, decay) for k, o in opts.items()}
    item = (cfg.channels, cfg.img_height, cfg.img_width)
    draws = torch.Generator().manual_seed(cfg.seed)
    bufs = {
        "buf_A": ReplayBuffer(50, item, device, draws),
        "buf_B": ReplayBuffer(50, item, device, draws),
    }
    return TrainState(modules, opts, scheds, bufs)


def make_step(cfg: Config, modules: dict, device):
    """``step(state, a_u8, b_u8) -> (state, out)``: one G update, then one
    update of D_A and of D_B (cyclegan.py:177-239). ``a_u8``/``b_u8`` are
    NHWC uint8 batches; ``out`` holds the five losses as 0-d tensors (global
    means under data parallelism). After the step each parameter's ``.grad``
    holds the gradient it was updated with. The step is the span
    ``tpugan.step``, its phases ``tpugan.step.g`` and ``tpugan.step.d``, the
    replay buffers inside the latter (``utils/tracing.py``)."""
    G_AB, G_BA = modules["G_AB"], modules["G_BA"]
    D_A, D_B = modules["D_A"], modules["D_B"]
    g_params = [*G_AB.parameters(), *G_BA.parameters()]
    device = torch.device(device)

    def d_update(state, name, D, real, fake_pool):
        opt = state.optimizers[name]
        opt.zero_grad(set_to_none=True)
        n = real.shape[0]
        pred = D(torch.cat([real, fake_pool]))
        loss = (mse(pred[:n], 1.0) + mse(pred[n:], 0.0)) / 2
        loss.backward()
        opt.step()
        return loss.detach()

    def step(state: TrainState, a_u8, b_u8):
        with tracing.span("tpugan.step", state.step):
            real_a = normalize_uint8(a_u8.to(device, non_blocking=True))
            real_b = normalize_uint8(b_u8.to(device, non_blocking=True))
            n = real_a.shape[0]

            # G phase. Only the generators' parameters take gradients; the
            # discriminators are applied but not updated here.
            with tracing.span("tpugan.step.g"):
                opt_g = state.optimizers["G"]
                opt_g.zero_grad(set_to_none=True)
                ab_out = G_AB(torch.cat([real_a, real_b]))
                fake_b, id_b = ab_out[:n], ab_out[n:]
                ba_out = G_BA(torch.cat([real_b, real_a]))
                fake_a, id_a = ba_out[:n], ba_out[n:]
                loss_identity = (l1(id_a, real_a) + l1(id_b, real_b)) / 2
                loss_gan = (mse(D_B(fake_b), 1.0) + mse(D_A(fake_a), 1.0)) / 2
                recov_a = G_BA(fake_b)
                recov_b = G_AB(fake_a)
                loss_cycle = (l1(recov_a, real_a) + l1(recov_b, real_b)) / 2
                g_loss = loss_gan + cfg.lambda_cyc * loss_cycle + cfg.lambda_id * loss_identity
                g_loss.backward(inputs=g_params)
                opt_g.step()

            # Replay buffers, on the global batch of fakes under data
            # parallelism, then the D phases on [real; replayed fake].
            with tracing.span("tpugan.step.d"):
                dp = state.dp
                fake_a_pool = local_rows(dp, state.buffers["buf_A"].push_and_pop(
                    gather_rows(dp, fake_a.detach())))
                fake_b_pool = local_rows(dp, state.buffers["buf_B"].push_and_pop(
                    gather_rows(dp, fake_b.detach())))
                loss_d_a = d_update(state, "D_A", D_A, real_a, fake_a_pool)
                loss_d_b = d_update(state, "D_B", D_B, real_b, fake_b_pool)

            state.step += 1
            out = {
                "d_loss": (loss_d_a + loss_d_b) / 2,
                "g_loss": g_loss.detach(),
                "loss_GAN": loss_gan.detach(),
                "loss_cycle": loss_cycle.detach(),
                "loss_identity": loss_identity.detach(),
            }
            return state, global_means(dp, out, tuple(out))

    return step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2,
                dp=None):
    a, b, is_real = unpaired_or_synthetic(
        cfg.data_dir, cfg.dataset_name, cfg.img_height, cfg.img_width,
        split=split, synthetic=cfg.synthetic_data, seed=cfg.seed,
    )
    if not is_real and split == "train":
        print("[tpugan] dataset %r not found on disk — using synthetic domains" % cfg.dataset_name)
    transform = (
        resize_crop_flip_transform(cfg.seed, cfg.img_height, cfg.img_width, indices=(0, 1))
        if split == "train"
        else None
    )
    return UnpairedLoader(
        a, b, batch_size or cfg.batch_size, device,
        seed=cfg.seed if split == "train" else cfg.seed + 991,
        prefetch=prefetch, host_transform=transform, dp=dp,
    )


def make_sampler(cfg: Config, modules: dict, device):
    """cyclegan.py:135-151: four stacked make_grid rows (real_A, fake_B,
    real_B, fake_A) of five test images each, to images/<dataset>/<N>.png."""
    G_AB, G_BA = modules["G_AB"], modules["G_BA"]
    val_loader = make_loader(cfg, device, split="test", batch_size=5, prefetch=0)
    imgdir, _ = out_dirs(cfg)

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, b_u8 = first_batch(val_loader, batches_done)
        real_a, real_b = normalize_uint8(a_u8), normalize_uint8(b_u8)
        rows = (real_a, G_AB(real_a), real_b, G_BA(real_b))
        grids = [
            make_grid(r.permute(0, 2, 3, 1).float().cpu().numpy(), nrow=5, normalize=True)
            for r in rows
        ]
        save_image(
            np.concatenate(grids, axis=0)[None],
            "%s/%s.png" % (imgdir, batches_done),
            nrow=1, normalize=False, padding=0,
        )

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
        lambda out: "[D loss: %f] [G loss: %f, adv: %f, cycle: %f, identity: %f]" % (
            float(out["d_loss"]), float(out["g_loss"]), float(out["loss_GAN"]),
            float(out["loss_cycle"]), float(out["loss_identity"])),
        modules, MODULES, epoch_end=lambda: [s.step() for s in state.schedulers.values()])


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
