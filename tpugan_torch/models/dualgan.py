"""DualGAN (Yi et al. 2017): the port of ``tpugan/models/dualgan.py``.

Two 7-down/6-up U-Nets with affine InstanceNorm and a transposed-conv final
(dualgan/models.py:22-94), two BatchNorm(eps 0.8) PatchGAN critics with an
unpadded 4x4 head after ZeroPad2d((1, 0, 1, 0)) (models.py:102-123), at
128px, batch 8, on paired data. WGAN-GP per domain (lambda 10,
dualgan.py:116-135, 179-194): the critics train every batch on fresh fakes,
detached, and both step from one backward; the generators every
``n_critic``-th batch on -mean(D_A(fake_A)) - mean(D_B(fake_B)) + 10 * cycle
L1 (dualgan.py:200-224). The host loop drives the schedule, as in JAX.

The generators' IN runs through the port's instance-norm kernel pair at
slope 1, the affine and the activation after it (``nn/im2im.py``). The
critics' BatchNorm running statistics take two updates a critic step (real,
then fake) and one a generator step; the penalty's forward normalizes by its
batch statistics and leaves the running ones alone (``batch_stats_frozen``),
as the JAX package drops that update (``tpugan/models/dualgan.py:144-168``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import l1
from tpugan_torch.models._common import sample_generator, save_grid
from tpugan_torch.models._im2im_common import (
    EtaLogger,
    checkpoint_epoch,
    first_batch,
    maybe_resume,
    out_dirs,
    paired_loader,
)
from tpugan_torch.nn.im2im import PatchGAN, UNet, UNetDown, UNetUp, _numbered
from tpugan_torch.nn.layers import ConvTranspose2d, batch_stats_frozen
from tpugan_torch.ops.penalty import wgan_gp_penalty
from tpugan_torch.train.loop import StepObserver, train_device
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "dualgan"
MODULES = ("G_AB", "G_BA", "D_A", "D_B")
LAMBDA_ADV, LAMBDA_CYCLE, LAMBDA_GP = 1.0, 10.0, 10.0  # dualgan.py:56-58


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with dualgan.py:28-41 and tpugan.models.dualgan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(8, "size of the batches")
    dataset_name: str = flag("edges2shoes", "name of the dataset")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_size: int = flag(128, "size of each image dimension")
    channels: int = flag(3, "number of image channels")
    n_critic: int = flag(5, "number of training steps for discriminator per iter")
    sample_interval: int = flag(200, "interval betwen image samples")
    checkpoint_interval: int = flag(-1, "interval between model checkpoints")


class DualGenerator(UNet):
    """dualgan/models.py:57-94: 7 downs and 6 ups, bias-free convs, affine
    IN, dropout 0.5 at d4-d7 and u1-u3 (seven sites), then a transposed
    4x4 conv and tanh."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        kw = dict(norm="affine", generator=generator)
        downs = [UNetDown(channels, 64, normalize=False, **kw), UNetDown(64, 128, **kw),
                 UNetDown(128, 256, **kw), UNetDown(256, 512, dropout=0.5, **kw),
                 UNetDown(512, 512, dropout=0.5, **kw), UNetDown(512, 512, dropout=0.5, **kw),
                 UNetDown(512, 512, normalize=False, dropout=0.5, **kw)]
        ups = [UNetUp(512, 512, dropout=0.5, **kw), UNetUp(1024, 512, dropout=0.5, **kw),
               UNetUp(1024, 512, dropout=0.5, **kw), UNetUp(1024, 256, **kw),
               UNetUp(512, 128, **kw), UNetUp(256, 64, **kw)]
        final = _numbered([(ConvTranspose2d(128, channels, 4, 2, 1, generator=generator), 1),
                           (nn.Tanh(), 1)])
        super().__init__(downs, ups, final)


def build(cfg: Config, device) -> dict:
    """G_AB, G_BA, D_A, D_B with weights drawn from a generator seeded by
    ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    g = lambda: DualGenerator(cfg.channels, generator=gen)
    d = lambda: PatchGAN(cfg.channels, head_bias=True, generator=gen, filters=(64, 128, 256),
                         norm="batch08", head_padding=0, init_mode="normal02")
    modules = {"G_AB": g(), "G_BA": g(), "D_A": d(), "D_B": d()}
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam over both generators, one for each critic, and a device
    generator of the draws seeded by ``--seed``."""
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    opts = {"G": adam([*modules["G_AB"].parameters(), *modules["G_BA"].parameters()]),
            "D_A": adam(modules["D_A"].parameters()), "D_B": adam(modules["D_B"].parameters())}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, opts, draws)


def make_steps(cfg: Config, state: TrainState):
    """``(d_step, g_step)``, each ``(state, a_u8, b_u8, masks=None, ...) ->
    (state, out)``: the critics every batch, the generators every
    ``n_critic``-th (dualgan.py:158-224).

    ``d_step`` takes ``masks`` for its two generator forwards, G_BA(b) then
    G_AB(a), and ``alphas``, the penalty's (B, 1, 1, 1) alpha for domain A
    then B; ``g_step`` takes ``masks`` for G_BA(b), G_AB(a), G_BA(fake_b),
    G_AB(fake_a). What is None is drawn from ``state.draws``: the masks as
    the forwards run, then the alphas. ``d_step``'s ``out`` holds ``d_loss``;
    ``g_step``'s ``g_adv``, ``g_cycle`` and ``g_loss``."""
    G_AB, G_BA, D_A, D_B = (state.modules[k] for k in MODULES)
    g_params = [*G_AB.parameters(), *G_BA.parameters()]

    def critic_loss(D, real, fake, alpha):
        with batch_stats_frozen(D):
            gp = wgan_gp_penalty(D, real, fake, alpha)
        return -torch.mean(D(real).float()) + torch.mean(D(fake).float()) + LAMBDA_GP * gp

    def d_step(state: TrainState, a_u8, b_u8, masks=None, alphas=None):
        device = state.draws.device
        imgs_a = normalize_uint8(a_u8.to(device, non_blocking=True))
        imgs_b = normalize_uint8(b_u8.to(device, non_blocking=True))
        m = masks if masks is not None else [None] * 2
        with torch.no_grad():
            fake_a = G_BA(imgs_b, m[0], state.draws)
            fake_b = G_AB(imgs_a, m[1], state.draws)
        if alphas is None:
            shape = (imgs_a.shape[0], 1, 1, 1)
            alphas = [torch.rand(shape, generator=state.draws, device=device) for _ in range(2)]
        opt_a, opt_b = state.optimizers["D_A"], state.optimizers["D_B"]
        opt_a.zero_grad(set_to_none=True)
        opt_b.zero_grad(set_to_none=True)
        d_loss = (critic_loss(D_A, imgs_a, fake_a, alphas[0])
                  + critic_loss(D_B, imgs_b, fake_b, alphas[1]))
        d_loss.backward()
        opt_a.step()
        opt_b.step()
        state.step += 1
        return state, {"d_loss": d_loss.detach()}

    def g_step(state: TrainState, a_u8, b_u8, masks=None):
        device = state.draws.device
        imgs_a = normalize_uint8(a_u8.to(device, non_blocking=True))
        imgs_b = normalize_uint8(b_u8.to(device, non_blocking=True))
        m = masks if masks is not None else [None] * 4
        opt_g = state.optimizers["G"]
        opt_g.zero_grad(set_to_none=True)
        fake_a = G_BA(imgs_b, m[0], state.draws)
        fake_b = G_AB(imgs_a, m[1], state.draws)
        recov_a = G_BA(fake_b, m[2], state.draws)
        recov_b = G_AB(fake_a, m[3], state.draws)
        g_adv = -torch.mean(D_A(fake_a).float()) - torch.mean(D_B(fake_b).float())
        g_cycle = l1(recov_a, imgs_a) + l1(recov_b, imgs_b)
        g_loss = LAMBDA_ADV * g_adv + LAMBDA_CYCLE * g_cycle
        g_loss.backward(inputs=g_params)
        opt_g.step()
        return state, {"g_adv": g_adv.detach(), "g_cycle": g_cycle.detach(),
                       "g_loss": g_loss.detach()}

    return d_step, g_step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2):
    return paired_loader(cfg, device, cfg.img_size, cfg.img_size, split, batch_size, prefetch)


def make_sampler(cfg: Config, modules: dict, device):
    """dualgan.py:138-148: 16 validation pairs; each real_A over fake_B, then
    each real_B over fake_A, 8 a row, to images/<dataset>/<N>.png. The
    train-mode generators, their dropout masks drawn from
    ``_common.sample_generator``."""
    G_AB, G_BA = modules["G_AB"], modules["G_BA"]
    val_loader = make_loader(cfg, device, split="val", batch_size=16, prefetch=0)
    imgdir, _ = out_dirs(cfg)

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, b_u8 = first_batch(val_loader, batches_done)
        real_a, real_b = normalize_uint8(a_u8), normalize_uint8(b_u8)
        draws = sample_generator(cfg, batches_done, real_a.device)
        fake_b = G_AB(real_a, generator=draws)
        fake_a = G_BA(real_b, generator=draws)
        grid = torch.cat([torch.cat([real_a, fake_b], dim=2), torch.cat([real_b, fake_a], dim=2)])
        save_grid(grid, "%s/%s.png" % (imgdir, batches_done), 8)

    return sample


def run(cfg: Config, device=None) -> TrainState:
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off. The loop of
    ``tpugan/models/dualgan.py:run``: a critic step every batch, a generator
    step and the log line on every ``n_critic``-th, a sample every
    ``sample_interval`` batches."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    maybe_resume(modules, cfg, MODULES)
    loader = make_loader(cfg, device)
    state = create_state(cfg, modules, device)
    observer = StepObserver(cfg)
    d_step, g_step = map(observer.checked, make_steps(cfg, state))
    sample = make_sampler(cfg, modules, device)
    eta = EtaLogger(cfg.n_epochs)

    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    batches_done = cfg.epoch * bpe
    for epoch in range(cfg.epoch, cfg.n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                state, out = d_step(state, *batch)
                if i % cfg.n_critic != 0:
                    observer.observe(batches_done, out)
                else:
                    state, g_out = g_step(state, *batch)
                    observer.observe(batches_done, {**out, **g_out})
                    if cfg.log_interval > 0:
                        eta.line(epoch, i, bpe, "[D loss: %f] [G loss: %f, cycle: %f]" % (
                            float(out["d_loss"]), float(g_out["g_adv"]),
                            float(g_out["g_cycle"])))
                if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                    sample(state, out, batches_done)
                batches_done += 1
        checkpoint_epoch(modules, cfg, epoch, MODULES)
    observer.close()
    return state


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
