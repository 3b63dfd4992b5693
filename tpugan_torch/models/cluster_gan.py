"""ClusterGAN (Mukherjee et al. 2019): the port of ``tpugan/models/cluster_gan.py``.

``GeneratorCNN`` (Linear 1024, BatchNorm1d, Linear 128*7*7, BatchNorm1d,
reshape, two ConvTranspose2d, Sigmoid; clustergan.py:143-193),
``EncoderCNN`` (two VALID stride-2 convs, Linear 1024, Linear to the 30
continuous and 10 categorical latents; returns (zn, softmax zc, logits);
clustergan.py:196-245) and ``DiscriminatorCNN`` (the same conv stack,
Linear 1, and a Sigmoid unless ``--wass_flag``; clustergan.py:248-297).
Every Conv, ConvTranspose and Linear is N(0, 0.02) with zero bias
(``normal02zero``, ``initialize_weights``, clustergan.py:106-116); the
BatchNorms keep torch's init. The latent is 0.75 * N(0, 1) beside a
one-hot class (``sample_z``, clustergan.py:41-68). MNIST at 28x28 as
ToTensor gives it, in [0, 1], with no 0.5 normalisation (clustergan.py:356).

The schedule (clustergan.py:398-475): every batch trains D, and every
``n_critic``-th batch first trains G and E together (``full_step``; the
others ``d_step``). G and E share one Adam, betas (0.5, 0.9), with weight
decay 2.5e-5 folded into the gradient as torch's ``Adam(weight_decay=)``
does (clustergan.py:380-384); D has its own. The GE loss is the adversarial
term (BCE(D(G(z)), 1), or mean(D(G(z))) under ``--wass_flag``) + 10 *
MSE(E's zn, zn) + 10 * CE(E's logits, the class); D's is the BCE pair, or
mean(D(real)) - mean(D(G(z))) + 10 * the gradient penalty with 1e-12 inside
the norm's square root. Both losses see D at its pre-update parameters and
the same fakes (clustergan.py:428-429,465).

The trainer's own host loop (``run``), as the JAX package's: no fused
dispatch (``--steps_per_dispatch`` above 1 prints the notice and runs per
step), the losses printed at each epoch's end, then the epoch-end
evaluation in eval mode: the three cycle losses and the sheets
``cycle_reg_%06i.png``, ``gen_%06i.png`` and ``gen_classes_%06i.png``
(clustergan.py:483-566). No kernel of the port runs here.

Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/cluster_gan.py:416``):
each rank loads its rows of every global batch, the draws are the global
batch's, G's BatchNorms take global statistics, the losses read once an
epoch are global means, and rank 0 alone prints them and runs the epoch-end
evaluation (G in eval mode: no collective) and writes its sheets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.data.loader import DeviceLoader
from tpugan_torch.data.sources import mnist_or_synthetic
from tpugan_torch.losses import bce, cross_entropy_logits, mse
from tpugan_torch.models._common import sample_generator, save_grid
from tpugan_torch.nn.layers import (
    BatchNorm1d,
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    LeakyReLU,
    Linear,
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
from tpugan_torch.train.optim import capturable
from tpugan_torch.train.state import TrainState
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "cluster_gan"
N_C = 10  # clustergan.py:317
BETA_N = 10.0  # clustergan.py:318
BETA_C = 10.0  # clustergan.py:319
B1, B2 = 0.5, 0.9  # clustergan.py:306-307
DECAY = 2.5e-5  # clustergan.py:308
GP_LAMBDA = 10.0  # clustergan.py:72
GP_NORM_EPS = 1e-12  # clustergan.py:95
N_SQRT_SAMP = 5  # the sheets' 5x5 grids, clustergan.py:489


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with clustergan.py:30-36 and tpugan.models.cluster_gan.Config.
    n_epochs: int = flag(200, "Number of epochs", short="-n")
    batch_size: int = flag(64, "Batch size", short="-b")
    img_size: int = flag(28, "Size of image dimension", short="-i")
    latent_dim: int = flag(30, "Dimension of latent space", short="-d")
    lr: float = flag(0.0001, "Learning rate", short="-l")
    n_critic: int = flag(
        5, "Number of training steps for discriminator per iter", short="-c"
    )
    wass_flag: bool = flag(False, "Flag for Wasserstein metric", short="-w")


class Reshape(nn.Module):
    """The reference's ``Reshape`` layer (clustergan.py:120-140),
    ``x.view(B, *shape)``; a reshape, since a one-channel batch may come in
    channels-last strides."""

    def __init__(self, *shape: int):
        super().__init__()
        self.shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], *self.shape)


class GeneratorCNN(nn.Module):
    """clustergan.py:143-193; ``forward(zn, zc)`` gives (B, 1, 28, 28)."""

    def __init__(self, latent_dim: int, n_c: int = N_C,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, init_mode="normal02zero", generator=generator)
        up = lambda i, o: ConvTranspose2d(i, o, 4, 2, 1, init_mode="normal02zero",
                                          generator=generator)
        self.model = nn.Sequential(
            lin(latent_dim + n_c, 1024), BatchNorm1d(1024), LeakyReLU(0.2),
            lin(1024, 128 * 7 * 7), BatchNorm1d(128 * 7 * 7), LeakyReLU(0.2),
            Reshape(128, 7, 7),
            up(128, 64), BatchNorm2d(64), LeakyReLU(0.2),
            up(64, 1), nn.Sigmoid(),
        )

    def forward(self, zn: torch.Tensor, zc: torch.Tensor) -> torch.Tensor:
        return self.model(torch.cat([zn, zc], dim=1))


def conv_stack(img_size: int, out_features: int, generator) -> nn.Sequential:
    """The encoder's and discriminator's ``model`` (clustergan.py:214-227,
    268-281): Conv(1 -> 64, 4, s2), LeakyReLU(0.2), Conv(64 -> 128, 4, s2),
    LeakyReLU(0.2), the reshape to 128 * s * s (s = 5 at 28px), Linear 1024,
    LeakyReLU(0.2), Linear to ``out_features``."""
    s = ((img_size - 4) // 2 + 1 - 4) // 2 + 1
    conv = lambda i, o: Conv2d(i, o, 4, 2, 0, init_mode="normal02zero", generator=generator)
    lin = lambda i, o: Linear(i, o, init_mode="normal02zero", generator=generator)
    return nn.Sequential(conv(1, 64), LeakyReLU(0.2), conv(64, 128), LeakyReLU(0.2),
                         Reshape(128 * s * s), lin(128 * s * s, 1024), LeakyReLU(0.2),
                         lin(1024, out_features))


class EncoderCNN(nn.Module):
    """clustergan.py:196-245: ``forward(img)`` returns (zn, softmax zc,
    zc logits)."""

    def __init__(self, img_size: int, latent_dim: int, n_c: int = N_C,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.model = conv_stack(img_size, latent_dim + n_c, generator)

    def forward(self, img: torch.Tensor):
        z = self.model(img)
        zn, logits = z[:, :self.latent_dim], z[:, self.latent_dim:]
        return zn, torch.softmax(logits, dim=1), logits


class DiscriminatorCNN(nn.Module):
    """clustergan.py:248-297: the conv stack to one output; without the
    Wasserstein metric the reference wraps it as ``nn.Sequential(model,
    Sigmoid())``, and the keys follow (``model.0.*``)."""

    def __init__(self, img_size: int, wass_metric: bool,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        model = conv_stack(img_size, 1, generator)
        self.model = model if wass_metric else nn.Sequential(model, nn.Sigmoid())

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)


def sample_z(n: int, latent_dim: int, generator: torch.Generator, device,
             fix_class: int = -1):
    """clustergan.py:41-68: zn = 0.75 * N(0, 1) of (n, latent_dim), then the
    class index (uniform over the 10, or ``fix_class``) and its one-hot zc,
    drawn from ``generator`` in that order. Returns (zn, zc, index)."""
    zn = 0.75 * torch.randn(n, latent_dim, generator=generator, device=device)
    if fix_class == -1:
        idx = torch.randint(0, N_C, (n,), generator=generator, device=device)
    else:
        idx = torch.full((n,), fix_class, dtype=torch.long, device=device)
    return zn, F.one_hot(idx, N_C).float(), idx


def build(cfg: Config, device) -> dict:
    """G, E and D drawn from a generator seeded by ``--seed`` on the CPU."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": GeneratorCNN(cfg.latent_dim, generator=gen),
        "encoder": EncoderCNN(cfg.img_size, cfg.latent_dim, generator=gen),
        "discriminator": DiscriminatorCNN(cfg.img_size, cfg.wass_flag, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """``"ge"``: Adam(lr, (0.5, 0.9), weight_decay 2.5e-5) over G's and then
    E's parameters (itertools.chain, clustergan.py:380-384); D's Adam(lr,
    (0.5, 0.9)); capturable on CUDA; the draws' generator seeded by
    ``--seed``."""
    ge = itertools.chain(modules["generator"].parameters(), modules["encoder"].parameters())
    optimizers = {
        "ge": torch.optim.Adam(ge, lr=cfg.lr, betas=(B1, B2), weight_decay=DECAY,
                               **capturable(device)),
        "discriminator": torch.optim.Adam(modules["discriminator"].parameters(), lr=cfg.lr,
                                          betas=(B1, B2), **capturable(device)),
    }
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, optimizers, draws)


def to_unit_range(imgs_u8: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 to NCHW float32 in [0, 1]: ToTensor with no normalisation."""
    return (imgs_u8.permute(0, 3, 1, 2).float() / 255.0).contiguous()


def make_steps(cfg: Config, state: TrainState):
    """``(full_step, d_step)``, each ``step(state, imgs_u8, labels=None,
    zn=None, zc_idx=None, alpha=None) -> (state, out)``: ``full_step`` is one
    G+E update, then one D update, both at the pre-update parameters and on
    the same fakes; ``d_step`` is one D update on fakes from G in training
    mode (its BatchNorm statistics advance). Draws, from ``state.draws`` in
    this order unless passed in: ``zn`` (B, latent_dim), already scaled by
    0.75; ``zc_idx`` (B,), the classes; and, under ``--wass_flag``,
    ``alpha`` (B, 1, 1, 1), the penalty's. ``out`` holds ``d_loss``, and in
    ``full_step`` ``ge_loss``, and ``gen_imgs`` (NCHW). Under data
    parallelism (``state.dp``) the draws are the global batch's, drawn or
    passed in, each step keeps this rank's rows and the losses in ``out``
    are global means."""
    G, E, D = (state.modules[k] for k in ("generator", "encoder", "discriminator"))
    opt_ge, opt_d = state.optimizers["ge"], state.optimizers["discriminator"]
    ge_params = list(G.parameters()) + list(E.parameters())
    d_params = list(D.parameters())

    def draw(state, real, zn, zc_idx, alpha):
        dp, device = state.dp, state.draws.device
        b = global_batch(dp, real.shape[0])
        if zn is None:
            zn = 0.75 * torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if zc_idx is None:
            zc_idx = torch.randint(0, N_C, (b,), generator=state.draws, device=device)
        if alpha is None and cfg.wass_flag:
            alpha = torch.rand(b, 1, 1, 1, generator=state.draws, device=device)
        if alpha is not None:
            alpha = local_rows(dp, alpha)
        return local_rows(dp, zn), local_rows(dp, zc_idx), alpha

    def d_update(real, fake, alpha):
        """D's loss at its current parameters, and its step."""
        opt_d.zero_grad(set_to_none=True)
        d_gen, d_real = D(fake).float(), D(real).float()
        if cfg.wass_flag:
            gp = wgan_gp_penalty(D, real, fake, alpha, norm_eps=GP_NORM_EPS)
            d_loss = torch.mean(d_real) - torch.mean(d_gen) + GP_LAMBDA * gp
        else:
            d_loss = (bce(d_real, 1.0) + bce(d_gen, 0.0)) / 2
        d_loss.backward(inputs=d_params)
        opt_d.step()
        return d_loss.detach()

    def full_step(state: TrainState, imgs_u8, labels=None, zn=None, zc_idx=None, alpha=None):
        del labels
        real = to_unit_range(imgs_u8.to(state.draws.device, non_blocking=True))
        zn, zc_idx, alpha = draw(state, real, zn, zc_idx, alpha)

        # GE phase (clustergan.py:417-451).
        opt_ge.zero_grad(set_to_none=True)
        gen = G(zn, F.one_hot(zc_idx, N_C).float())
        d_gen = D(gen).float()
        ge_adv = torch.mean(d_gen) if cfg.wass_flag else bce(d_gen, 1.0)
        enc_zn, _, enc_logits = E(gen)
        ge_loss = (ge_adv + BETA_N * mse(enc_zn, zn)
                   + BETA_C * cross_entropy_logits(enc_logits, zc_idx))
        ge_loss.backward(inputs=ge_params)
        opt_ge.step()

        # D phase (clustergan.py:455-472), D unchanged by the GE update.
        fake = gen.detach()
        d_loss = d_update(real, fake, alpha)
        state.step += 1
        out = {"d_loss": d_loss, "ge_loss": ge_loss.detach(), "gen_imgs": fake}
        return state, global_means(state.dp, out, ("d_loss", "ge_loss"))

    def d_step(state: TrainState, imgs_u8, labels=None, zn=None, zc_idx=None, alpha=None):
        del labels
        real = to_unit_range(imgs_u8.to(state.draws.device, non_blocking=True))
        zn, zc_idx, alpha = draw(state, real, zn, zc_idx, alpha)
        with torch.no_grad():
            fake = G(zn, F.one_hot(zc_idx, N_C).float())
        d_loss = d_update(real, fake, alpha)
        state.step += 1
        return state, global_means(state.dp, {"d_loss": d_loss, "gen_imgs": fake}, ("d_loss",))

    return full_step, d_step


def make_loader(cfg: Config, device, dp=None) -> DeviceLoader:
    """MNIST (or the synthetic glyphs) at ``--img_size``, one channel,
    shuffled from ``--seed`` (clustergan.py:344-362); this rank's share of
    each batch under ``dp``."""
    ds, is_real = mnist_or_synthetic(cfg.data_dir, img_size=cfg.img_size, channels=1,
                                     synthetic=cfg.synthetic_data, seed=cfg.seed)
    if not is_real:
        print("[tpugan] MNIST not found on disk — using synthetic dataset")
    return DeviceLoader([ds.images, ds.labels], cfg.batch_size, device, shuffle=True,
                        seed=cfg.seed, dp=dp)


def make_epoch_eval(cfg: Config, device):
    """``epoch_end(state, epoch) -> (img_mse, lat_mse, lat_xe)``: the
    epoch-end cycle losses and sample sheets (clustergan.py:483-566), with
    G in eval mode (BatchNorm on its running statistics), on the first
    ``--batch_size`` images of the evaluation set; the draws from a
    generator of its own seeded from (``--seed``, epoch), so
    ``state.draws`` stays as it was. Writes ``cycle_reg_%06i.png`` (the
    first 25 test images through E and G), ``gen_%06i.png`` (25 samples) and
    ``gen_classes_%06i.png`` (10 rows of 10 samples of one class each) and
    prints the reference's ``Cycle Losses`` line."""
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    ds, _ = mnist_or_synthetic(cfg.data_dir, img_size=cfg.img_size, channels=1,
                               synthetic=cfg.synthetic_data, seed=cfg.seed + 1)
    test_imgs = to_unit_range(torch.from_numpy(ds.images[:cfg.batch_size])).to(device)
    n_samp = N_SQRT_SAMP * N_SQRT_SAMP

    @torch.no_grad()
    def epoch_end(state, epoch):
        G, E = state.modules["generator"], state.modules["encoder"]
        gen = sample_generator(cfg, epoch, "cpu")
        draw = lambda n, fix=-1: [x.to(device) for x in sample_z(n, cfg.latent_dim, gen, "cpu",
                                                                   fix)]
        G.eval()
        try:
            e_tzn, e_tzc, _ = E(test_imgs)
            img_mse = mse(test_imgs, G(e_tzn, e_tzc))
            zn, zc, idx = draw(n_samp)
            gen_samp = G(zn, zc)
            zn_e, _, logits_e = E(gen_samp)
            lat_mse = mse(zn_e, zn)
            lat_xe = cross_entropy_logits(logits_e, idx)
            stack = torch.cat([G(*draw(N_C, c)[:2]) for c in range(N_C)])
            e_zn, e_zc, _ = E(test_imgs[:n_samp])
            reg_imgs = G(e_zn, e_zc)
        finally:
            G.train()
        save_grid(reg_imgs, os.path.join(imgdir, "cycle_reg_%06i.png" % epoch), N_SQRT_SAMP)
        save_grid(gen_samp, os.path.join(imgdir, "gen_%06i.png" % epoch), N_SQRT_SAMP)
        save_grid(stack, os.path.join(imgdir, "gen_classes_%06i.png" % epoch), N_C)
        print("\tCycle Losses: [x: %f] [z_n: %f] [z_c: %f]"
              % (float(img_mse), float(lat_mse), float(lat_xe)))
        return img_mse, lat_mse, lat_xe

    return epoch_end


def run(cfg: Config, device=None):
    """Train with the reference's host loop (clustergan.py:398-566). ``device``
    None means CUDA, and raises when there is none; the tests pass the CPU.
    On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, build(cfg, device), device))
    loader = make_loader(cfg, device, dp=dp)
    observer = StepObserver(cfg)
    full_step, d_step = map(observer.checked, make_steps(cfg, state))
    epoch_end = make_epoch_eval(cfg, device)
    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    writer = is_writer()
    if writer:
        print("\nBegin training session with %i epochs...\n" % cfg.n_epochs)
    ge_loss = d_loss = float("nan")
    for epoch in range(cfg.n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                if i % cfg.n_critic == 0:
                    state, out = full_step(state, *batch)
                    ge_loss = out["ge_loss"]
                else:
                    state, out = d_step(state, *batch)
                observer.observe(epoch * bpe + i, out)
                d_loss = out["d_loss"]
        # The losses are read once an epoch, not after every step.
        if writer:
            print("[Epoch %d/%d] \n\tModel Losses: [D: %f] [GE: %f]"
                  % (epoch, cfg.n_epochs, float(d_loss), float(ge_loss)))
        rank_zero_write(lambda: epoch_end(state, epoch))
    observer.close()
    return state


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
