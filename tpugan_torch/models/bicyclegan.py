"""BicycleGAN (Zhu et al. 2017), multimodal paired translation: the port of
``tpugan/models/bicyclegan.py``.

Networks (bicyclegan/models.py): the U-Net generator G(img, z), z projected
by a Linear to one extra input channel, 3x3 stride-2 downs with
BatchNorm(0.8) (:52-94); the VAE encoder, torchvision's ResNet18 trunk,
AvgPool(8), then ``fc_mu`` and ``fc_logvar`` (:102-118); two
MultiDiscriminators of three BatchNorm(0.8) towers, the input
AvgPool(3, s2, p1, count_include_pad=False)-downsampled before each tower
after the first (:126-165; the reference's ``AvgPool2d(in_channels, ...)``
is a NameError as written, and the kernel 3 of its munit twin is the fix the
JAX package takes). ``normal02`` init on G and the Ds, none on the encoder
(bicyclegan.py:74-78). Adam(2e-4, 0.5, 0.999) for each of the four, at
128px, batch 8, latent 8.

The step (bicyclegan.py:152-221): one backward of loss_GE = cVAE adv + cLR
adv + 10 * pixel + 0.01 * KL, its graph retained; the encoder steps on it.
Then the latent L1 of the UPDATED encoder on the retained cLR fake adds its
gradient to G's, and G steps on the sum. D_VAE and D_LR train on the
detached fakes. BatchNorm statistics move once a forward, in the JAX
package's order: G twice, the encoder on the real B then on the cLR fake,
each D three times. (The JAX step derives the cLR fake again for the latent
loss and drops that forward's statistics; the port reuses the fake.)

eps and the sampled z come from ``state.draws`` (or are passed in). The
sampler writes, for each of 8 validation A images, a row of the original
and ``latent_dim`` translations with z from a generator of its own,
through the eval-mode generator. Checkpoints ``<module>_<E>.pth`` for
generator, encoder, D_VAE and D_LR; ``--epoch N`` resumes. The training
loader flips nothing.

Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/bicyclegan.py:427-429``):
each rank loads its rows of the global batch; eps and z are drawn for the
global batch and each rank keeps its rows; every BatchNorm, the ResNet18
trunk's too, takes the global batch's statistics; the KL term, a sum over
the batch, is scaled by the ranks, so that the gradient mean is the global
sum's gradient; the losses are global means (the KL the global sum), and
rank 0 alone samples and writes checkpoints. The two-phase update holds:
each optimizer's gradient mean comes before its step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import l1
from tpugan_torch.models._common import sample_noise, save_grid
from tpugan_torch.models._im2im_common import (
    first_batch,
    maybe_resume,
    out_dirs,
    paired_loader,
    run_per_step,
)
from tpugan_torch.nn.layers import BatchNorm2d, Conv2d, LeakyReLU, Linear, Upsample
from tpugan_torch.nn.resnet import ResNet18Trunk
from tpugan_torch.nn.style import multi_d_loss
from tpugan_torch.ops.image import avg_pool
from tpugan_torch.parallel.mesh import (
    auto_sharding,
    global_batch,
    global_means,
    local_rows,
    replicate_for,
)
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "bicyclegan"
MODULES = ("generator", "encoder", "D_VAE", "D_LR")


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with bicyclegan.py:24-41 and tpugan.models.bicyclegan.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("edges2shoes", "name of the dataset")
    batch_size: int = flag(8, "size of the batches")
    lr: float = flag(0.0002, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(128, "size of image height")
    img_width: int = flag(128, "size of image width")
    channels: int = flag(3, "number of image channels")
    latent_dim: int = flag(8, "number of latent codes")
    sample_interval: int = flag(400, "interval between saving generator samples")
    checkpoint_interval: int = flag(-1, "interval between model checkpoints")
    lambda_pixel: float = flag(10.0, "pixelwise loss weight")
    lambda_latent: float = flag(0.5, "latent loss weight")
    lambda_kl: float = flag(0.01, "kullback-leibler loss weight")


def _bn(features: int, generator) -> BatchNorm2d:
    return BatchNorm2d(features, 0.8, init_mode="normal02", generator=generator)


class BiDown(nn.Module):
    """models.py:23-33: Conv(3, 2, 1, no bias), BatchNorm(0.8) unless
    ``normalize`` is False, LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, normalize: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [Conv2d(cin, cout, 3, 2, 1, bias=False, init_mode="normal02",
                         generator=generator)]
        if normalize:
            layers.append(_bn(cout, generator))
        self.model = nn.Sequential(*layers, LeakyReLU(0.2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class BiUp(nn.Module):
    """models.py:36-49: nearest 2x, Conv(3, 1, 1, no bias), BatchNorm(0.8),
    ReLU, then the skip concatenated after."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(
            Upsample(2),
            Conv2d(cin, cout, 3, 1, 1, bias=False, init_mode="normal02", generator=generator),
            _bn(cout, generator), nn.ReLU())

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.model(x), skip], 1)


class BicycleGenerator(nn.Module):
    """models.py:52-94: the 7-down/6-up U-Net over cat(img, fc(z) viewed as
    one H x W channel)."""

    def __init__(self, latent_dim: int, channels: int, height: int, width: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.h, self.w = height, width
        self.fc = Linear(latent_dim, height * width, generator=g)
        downs = ((channels + 1, 64, False), (64, 128, True), (128, 256, True),
                 (256, 512, True), (512, 512, True), (512, 512, True), (512, 512, False))
        for i, (cin, cout, norm) in enumerate(downs, 1):
            self.add_module(f"down{i}", BiDown(cin, cout, norm, g))
        ups = ((512, 512), (1024, 512), (1024, 512), (1024, 256), (512, 128), (256, 64))
        for i, (cin, cout) in enumerate(ups, 1):
            self.add_module(f"up{i}", BiUp(cin, cout, g))
        self.final = nn.Sequential(
            Upsample(2), Conv2d(128, channels, 3, 1, 1, init_mode="normal02", generator=g),
            nn.Tanh())

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        zmap = self.fc(z).view(z.shape[0], 1, self.h, self.w)
        skips = [torch.cat([x, zmap], 1)]
        for i in range(1, 8):
            skips.append(getattr(self, f"down{i}")(skips[-1]))
        y = skips[7]
        for i in range(1, 7):
            y = getattr(self, f"up{i}")(y, skips[7 - i])
        return self.final(y)


class BicycleEncoder(nn.Module):
    """models.py:102-118: the ResNet18 trunk, AvgPool(8), then ``fc_mu`` and
    ``fc_logvar`` on the flattened features (256 at 128px)."""

    def __init__(self, latent_dim: int, channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_extractor = ResNet18Trunk(channels, generator)
        self.pooling = nn.AvgPool2d(8, 8, 0)
        self.fc_mu = Linear(256, latent_dim, generator=generator)
        self.fc_logvar = Linear(256, latent_dim, generator=generator)

    def forward(self, img: torch.Tensor):
        feat = self.pooling(self.feature_extractor(img)).flatten(1)
        return self.fc_mu(feat), self.fc_logvar(feat)


class BicycleMultiD(nn.Module):
    """models.py:126-165: three towers of Conv(4, 2, 1), BatchNorm(0.8) on
    all but the first, LeakyReLU(0.2), four times, then a 3x3 head; each
    tower after the first sees the input AvgPool-downsampled once more.
    Returns the list of tower outputs."""

    def __init__(self, channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.models = nn.ModuleList()
        for k in range(3):
            layers, cin = [], channels
            for i, f in enumerate((64, 128, 256, 512)):
                layers.append(Conv2d(cin, f, 4, 2, 1, init_mode="normal02", generator=g))
                if i > 0:
                    layers.append(_bn(f, g))
                layers.append(LeakyReLU(0.2))
                cin = f
            layers.append(Conv2d(cin, 1, 3, 1, 1, init_mode="normal02", generator=g))
            self.models.add_module("disc_%d" % k, nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> list:
        outputs = []
        for k, tower in enumerate(self.models):
            if k:
                x = avg_pool(x, 3, 2, 1, count_include_pad=False)
            outputs.append(tower(x))
        return outputs


def build(cfg: Config, device) -> dict:
    """The four modules with weights drawn from a generator seeded by
    ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    modules = {
        "generator": BicycleGenerator(cfg.latent_dim, cfg.channels, cfg.img_height,
                                      cfg.img_width, generator=gen),
        "encoder": BicycleEncoder(cfg.latent_dim, cfg.channels, generator=gen),
        "D_VAE": BicycleMultiD(cfg.channels, generator=gen),
        "D_LR": BicycleMultiD(cfg.channels, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state(cfg: Config, modules: dict, device) -> TrainState:
    """Adam(lr, (b1, b2)) for each module and a device generator of the
    steps' eps and z, seeded by ``--seed``."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, {k: adam(modules[k]) for k in MODULES}, draws)


def make_step(cfg: Config, state: TrainState):
    """``step(state, a_u8, b_u8, eps=None, sampled_z=None) -> (state,
    out)``: the two-phase E/G update, then D_VAE's and D_LR's. eps and the
    sampled z, each (B, latent_dim), are drawn from ``state.draws`` in that
    order when not given; under data parallelism (``state.dp``) both are the
    global batch's, drawn or passed in, and the step keeps this rank's rows.
    ``out`` holds ``loss_D_VAE``, ``loss_D_LR``, ``g_loss`` (loss_GE),
    ``loss_pixel``, ``loss_kl`` and ``loss_latent`` as 0-d tensors (global
    means; ``loss_kl`` the global batch's sum)."""
    G, E = state.modules["generator"], state.modules["encoder"]
    D_VAE, D_LR = state.modules["D_VAE"], state.modules["D_LR"]
    opt = state.optimizers
    e_params, g_params = list(E.parameters()), list(G.parameters())

    def d_update(name: str, D, real_b, fake_b):
        opt[name].zero_grad(set_to_none=True)
        loss = multi_d_loss(D(real_b), 1.0) + multi_d_loss(D(fake_b), 0.0)
        loss.backward()
        opt[name].step()
        return loss.detach()

    def step(state: TrainState, a_u8, b_u8, eps=None, sampled_z=None):
        device = state.draws.device
        real_a = normalize_uint8(a_u8.to(device, non_blocking=True))
        real_b = normalize_uint8(b_u8.to(device, non_blocking=True))
        dp = state.dp
        shape = (global_batch(dp, real_a.shape[0]), cfg.latent_dim)
        if eps is None:
            eps = torch.randn(shape, generator=state.draws, device=device)
        if sampled_z is None:
            sampled_z = torch.randn(shape, generator=state.draws, device=device)
        eps, sampled_z = local_rows(dp, eps), local_rows(dp, sampled_z)

        # Phase 1 (bicyclegan.py:152-188): loss_GE; the encoder steps on it.
        opt["encoder"].zero_grad(set_to_none=True)
        opt["generator"].zero_grad(set_to_none=True)
        mu, logvar = E(real_b)
        fake_b = G(real_a, eps * torch.exp(logvar / 2) + mu)
        loss_pixel = l1(fake_b, real_b)
        mu32, logvar32 = mu.float(), logvar.float()
        loss_kl = 0.5 * torch.sum(torch.exp(logvar32) + mu32 ** 2 - logvar32 - 1.0)
        if dp is not None:
            loss_kl = loss_kl * dp.world  # the ranks' gradient mean: the global sum's
        loss_vae_gan = multi_d_loss(D_VAE(fake_b), 1.0)
        _fake_b = G(real_a, sampled_z)
        loss_lr_gan = multi_d_loss(D_LR(_fake_b), 1.0)
        loss_ge = (loss_vae_gan + loss_lr_gan + cfg.lambda_pixel * loss_pixel
                   + cfg.lambda_kl * loss_kl)
        loss_ge.backward(inputs=e_params + g_params, retain_graph=True)
        opt["encoder"].step()

        # Phase 2 (:190-199): the updated encoder on the retained cLR fake;
        # G steps on both gradients.
        mu_, _ = E(_fake_b)
        loss_latent = cfg.lambda_latent * l1(mu_, sampled_z)
        loss_latent.backward(inputs=g_params)
        opt["generator"].step()

        # D_VAE and D_LR (:205-221) on the detached fakes.
        loss_d_vae = d_update("D_VAE", D_VAE, real_b, fake_b.detach())
        loss_d_lr = d_update("D_LR", D_LR, real_b, _fake_b.detach())

        state.step += 1
        out = {"loss_D_VAE": loss_d_vae, "loss_D_LR": loss_d_lr, "g_loss": loss_ge.detach(),
               "loss_pixel": loss_pixel.detach(), "loss_kl": loss_kl.detach(),
               "loss_latent": loss_latent.detach()}
        return state, global_means(dp, out, tuple(out))

    return step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2,
                dp=None):
    return paired_loader(cfg, device, cfg.img_height, cfg.img_width, split, batch_size,
                         prefetch, hflip=False, dp=dp)


def make_sampler(cfg: Config, modules: dict, device):
    """bicyclegan.py:102-122: for each of 8 validation A images a row of the
    original and ``latent_dim`` translations, normalized over the sheet, to
    images/<dataset>/<N>.png. One batched forward of the eval-mode
    generator (running statistics); z from ``_common.sample_noise``."""
    G = modules["generator"]
    val_loader = make_loader(cfg, device, split="val", batch_size=8, prefetch=0)
    imgdir, _ = out_dirs(cfg)
    n = cfg.latent_dim

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, _ = first_batch(val_loader, batches_done)
        x = normalize_uint8(a_u8)
        m, c, h, w = x.shape
        z = sample_noise(cfg, batches_done, (m * n, n), x.device)
        G.eval()
        try:
            fb = G(x.repeat_interleave(n, 0), z).view(m, n, c, h, w)
        finally:
            G.train()
        rows = torch.cat([x[:, None], fb], 1)  # (m, n + 1, C, H, W)
        sheet = rows.permute(2, 0, 3, 1, 4).reshape(1, c, m * h, (n + 1) * w)
        save_grid(sheet, "%s/%s.png" % (imgdir, batches_done), 1)

    return sample


def run(cfg: Config, device=None) -> TrainState:
    """Train through ``run_per_step``, checkpointing the four modules.
    ``device`` None means CUDA, and raises when there is none; the tests
    pass the CPU. On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    maybe_resume(modules, cfg, MODULES)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, modules, device))
    return run_per_step(
        cfg, make_loader(cfg, device, dp=dp), state, make_step(cfg, state),
        make_sampler(cfg, modules, device),
        lambda out: "[D VAE_loss: %f, LR_loss: %f] [G loss: %f, pixel: %f, kl: %f, latent: %f]"
        % tuple(float(out[k]) for k in ("loss_D_VAE", "loss_D_LR", "g_loss", "loss_pixel",
                                        "loss_kl", "loss_latent")),
        modules, MODULES)


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
