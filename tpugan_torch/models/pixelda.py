"""PixelDA (Bousmalis et al. 2017), pixel-level domain adaptation: the port
of ``tpugan/models/pixelda.py``.

A residual translator G(img, z), z entering through a Linear viewed as an
image-shaped NCHW map concatenated to the image (pixelda.py:54-92); a
discriminator and a task classifier that share one block design, Conv 3x3
stride 2, LeakyReLU(0.2), then InstanceNorm after all but the first
(pixelda.py:95-142), the classifier ending in Linear and Softmax. MNIST
(grey, repeated to three channels) to MNIST-M at 32px, batch 64.

G and the classifier share one Adam (pixelda.py:204-206) on
MSE(D(fake_B), 1) + 0.1 * (CE(clf(fake_B), y_A) + CE(clf(A), y_A)) / 2, CE
taken on the Softmax outputs as the reference does (the double softmax,
pixelda.py:136,147); then D on MSE of real MNIST-M against the detached
translations (pixelda.py:262-270). The step also returns the classifier's
accuracy on the translated batch (before its update) and on MNIST-M (after
it); the log line keeps their rolling 100-step means on the host
(pixelda.py:272-303).

The IN of the discriminator and the classifier runs through the port's
instance-norm kernel pair at slope 1 (the LeakyReLU comes before it). The
step makes no host read and draws z ~ U(-1, 1) from the state's device
generator, so ``--steps_per_dispatch K`` runs it inside a CUDA graph through
``run_training``.

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none.

Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/pixelda.py:290``): each
rank loads its rows of both domains' global batches (both members of the
``ZipLoader``), keeps its rows of the draws made for the global batch (z); the IN kernel runs on
the rank's rows;
every BatchNorm takes global statistics; the scalars are global means; rank
0 alone logs and writes the samples, gathered from the ranks.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from tpugan_torch.losses import cross_entropy_on_softmax, mse
from tpugan_torch.models._common import save_grid, two_domain_loader
from tpugan_torch.nn.layers import BatchNorm2d, Conv2d, InstanceNorm, LeakyReLU, Linear
from tpugan_torch.parallel.mesh import (
    auto_sharding,
    gather_rows,
    global_batch,
    global_means,
    local_rows,
    rank_zero_write,
    replicate_for,
)
from tpugan_torch.train.loop import Callbacks, run_training, train_device
from tpugan_torch.train.optim import capturable
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "pixelda"
LAMBDA_ADV, LAMBDA_TASK = 1.0, 0.1  # pixelda.py:149-151


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with pixelda.py:22-34 and tpugan.models.pixelda.Config.
    n_epochs: int = flag(200, "number of epochs of training")
    batch_size: int = flag(64, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    n_residual_blocks: int = flag(6, "number of residual blocks in generator")
    latent_dim: int = flag(10, "dimensionality of the noise input")
    img_size: int = flag(32, "size of each image dimension")
    channels: int = flag(3, "number of image channels")
    n_classes: int = flag(10, "number of classes in the dataset")
    sample_interval: int = flag(300, "interval betwen image samples")


def _conv(i, o, stride, gen):
    return Conv2d(i, o, 3, stride, 1, init_mode="normal02", generator=gen)


class ResidualBlock(nn.Module):
    """pixelda.py:54-67: Conv-BN-ReLU-Conv-BN with an identity skip, under
    ``block``; BatchNorm2d at the default eps with scale ~ N(1, 0.02)."""

    def __init__(self, features: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        bn = lambda: BatchNorm2d(features, init_mode="normal02", generator=g)
        self.block = nn.Sequential(_conv(features, features, 1, g), bn(), nn.ReLU(),
                                   _conv(features, features, 1, g), bn())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class PixelDAGenerator(nn.Module):
    """pixelda.py:70-92: ``fc`` (torch's init), ``l1`` (Conv3 over [image;
    noise map] and ReLU), ``resblocks``, ``l2`` (Conv3 and tanh)."""

    def __init__(self, img_size: int, channels: int, latent_dim: int, n_residual_blocks: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.img_shape = (channels, img_size, img_size)
        self.fc = Linear(latent_dim, channels * img_size ** 2, generator=g)
        self.l1 = nn.Sequential(_conv(channels * 2, 64, 1, g), nn.ReLU())
        self.resblocks = nn.Sequential(*[ResidualBlock(generator=g)
                                         for _ in range(n_residual_blocks)])
        self.l2 = nn.Sequential(_conv(64, channels, 1, g), nn.Tanh())

    def forward(self, img: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        noise_map = self.fc(z).view(img.shape[0], *self.img_shape)
        return self.l2(self.resblocks(self.l1(torch.cat([img, noise_map], dim=1))))


def blocks(channels: int, generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """The block stack of D and the classifier (pixelda.py:99-110, 124-133):
    Conv 3x3 stride 2, LeakyReLU(0.2), then IN but after the first, to 64,
    128, 256 and 512 filters; numbered as the reference's ``model``."""
    layers, fan_in = [], channels
    for i, f in enumerate((64, 128, 256, 512)):
        layers += [_conv(fan_in, f, 2, generator), LeakyReLU(0.2)]
        if i > 0:
            layers.append(InstanceNorm())
        fan_in = f
    return nn.Sequential(*layers)


class PixelDADiscriminator(nn.Module):
    """pixelda.py:95-117: the blocks and a Conv(512 -> 1, 3, 1, 1) patch
    head, as ``model``."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = blocks(channels, generator)
        self.model.append(_conv(512, 1, 1, generator))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)


class PixelDAClassifier(nn.Module):
    """pixelda.py:120-142: the blocks as ``model``, then ``output_layer``,
    Linear (torch's init) over the NCHW-flattened map and Softmax."""

    def __init__(self, img_size: int, channels: int, n_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = blocks(channels, generator)
        feat = 512 * (img_size // 2 ** 4) ** 2
        self.output_layer = nn.Sequential(Linear(feat, n_classes, generator=generator),
                                          nn.Softmax(dim=-1))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.model(img)
        return self.output_layer(x.reshape(x.shape[0], -1))


def build(cfg: Config, device) -> dict:
    """G, D and the classifier, weights drawn from a generator seeded by
    ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": PixelDAGenerator(cfg.img_size, cfg.channels, cfg.latent_dim,
                                      cfg.n_residual_blocks, generator=gen),
        "discriminator": PixelDADiscriminator(cfg.channels, generator=gen),
        "classifier": PixelDAClassifier(cfg.img_size, cfg.channels, cfg.n_classes, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """One Adam over G and the classifier (``g``), one for D, capturable on
    CUDA, and a device generator of the draws seeded by ``--seed``."""
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                           **capturable(device))
    opts = {"g": adam([*modules["generator"].parameters(), *modules["classifier"].parameters()]),
            "discriminator": adam(modules["discriminator"].parameters())}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, opts, draws)


def _accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (probs.argmax(dim=1) == labels).float().mean()


def make_step(cfg: Config, state: TrainState):
    """``step(state, imgs_a_u8, labels_a, imgs_b_u8, labels_b, z=None) ->
    (state, out)``: one update of G and the classifier, then one of D
    (pixelda.py:238-270). ``z`` is (B, latent_dim), drawn U(-1, 1) from
    ``state.draws`` unless passed. ``out`` holds ``d_loss``, ``g_loss``,
    ``acc`` and ``target_acc`` as 0-d tensors, and ``imgs_a``, ``fake_b`` and
    ``imgs_b`` (NCHW). Under data parallelism (``state.dp``) z is the global
    batch's, drawn or passed in, the step keeps this rank's rows and the
    scalars are global means (the accuracies means over each rank's equal
    share of rows)."""
    G, D, C = (state.modules[k] for k in ("generator", "discriminator", "classifier"))
    opt_g, opt_d = state.optimizers["g"], state.optimizers["discriminator"]
    g_params = [*G.parameters(), *C.parameters()]

    def step(state: TrainState, imgs_a_u8, labels_a, imgs_b_u8, labels_b, z=None):
        device = state.draws.device
        imgs_a = normalize_uint8(imgs_a_u8.to(device, non_blocking=True))
        imgs_b = normalize_uint8(imgs_b_u8.to(device, non_blocking=True))
        labels_a = labels_a.to(device, non_blocking=True)
        labels_b = labels_b.to(device, non_blocking=True)
        dp = state.dp
        if z is None:
            z = torch.rand(global_batch(dp, imgs_a.shape[0]), cfg.latent_dim,
                           generator=state.draws, device=device) * 2.0 - 1.0
        z = local_rows(dp, z)

        # G and classifier phase; D is applied but not updated.
        opt_g.zero_grad(set_to_none=True)
        fake_b = G(imgs_a, z)
        label_pred = C(fake_b)
        task = (cross_entropy_on_softmax(label_pred, labels_a)
                + cross_entropy_on_softmax(C(imgs_a), labels_a)) / 2
        g_loss = LAMBDA_ADV * mse(D(fake_b), 1.0) + LAMBDA_TASK * task
        g_loss.backward(inputs=g_params)
        opt_g.step()

        # D phase on MNIST-M and the detached translations.
        fake = fake_b.detach()
        opt_d.zero_grad(set_to_none=True)
        d_loss = (mse(D(imgs_b), 1.0) + mse(D(fake), 0.0)) / 2
        d_loss.backward()
        opt_d.step()

        with torch.no_grad():
            acc = _accuracy(label_pred.detach(), labels_a)
            target_acc = _accuracy(C(imgs_b), labels_b)
        state.step += 1
        out = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "acc": acc,
               "target_acc": target_acc, "imgs_a": imgs_a, "fake_b": fake, "imgs_b": imgs_b}
        return state, global_means(dp, out, ("d_loss", "g_loss", "acc", "target_acc"))

    return step


make_loader = two_domain_loader


def run(cfg: Config, device=None) -> TrainState:
    """Train through ``run_training`` (``--steps_per_dispatch K`` fuses K
    steps in a CUDA graph). ``device`` None means CUDA, and raises when there
    is none; the tests pass the CPU. On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, modules, device))
    loader = make_loader(cfg, device, dp=dp)
    step = make_step(cfg, state)
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    task_performance: list = []
    target_performance: list = []

    def log(epoch, i, bpe, out):
        acc, target_acc = float(out["acc"]), float(out["target_acc"])
        for window, v in ((task_performance, acc), (target_performance, target_acc)):
            window.append(v)
            if len(window) > 100:
                window.pop(0)
        print("[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f] "
              "[CLF acc: %3d%% (%3d%%), target_acc: %3d%% (%3d%%)]"
              % (epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]), float(out["g_loss"]),
                 100 * acc, 100 * np.mean(task_performance),
                 100 * target_acc, 100 * np.mean(target_performance)))

    def sample(state, out, batches_done):
        # pixelda.py:305-308: five of A over their translations over five of
        # B, stacked along the height.
        grid = torch.cat([gather_rows(dp, out[k])[:5] for k in ("imgs_a", "fake_b", "imgs_b")],
                         dim=2)
        rank_zero_write(lambda: save_grid(grid, os.path.join(imgdir, "%d.png" % batches_done),
                                          int(math.sqrt(cfg.batch_size))))

    return run_training(cfg, loader, state, step, Callbacks(log=log, sample=sample),
                        n_epochs=cfg.n_epochs, sample_interval=cfg.sample_interval)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
