"""UNIT (Liu et al. 2017), unsupervised image-to-image translation with a
shared latent space: the port of ``tpugan/models/unit.py``.

Two encoders (ReflectionPad + c7, two stride-2 downs, three residual blocks,
then the shared residual block ``shared_E``; unit/models.py:53-90) and two
generators (the shared block ``shared_G``, three residual blocks, two
transposed-conv ups, c7 and tanh; models.py:93-122), with the VAE
reparameterization z = mu + N(0, 1) (models.py:81-84), and two PatchGAN
discriminators of four stride-2 blocks with a plain 3x3 head
(models.py:130-154), at 256px, batch 1. ``shared_E`` and ``shared_G`` are
single modules held by both encoders or both generators (unit.py:60-65), so
each encoder's and generator's ``state_dict`` carries the reference's keys,
the shared block's among them; the checkpoints are the JAX package's eight
files, ``shared_E`` and ``shared_G`` on their own as well.

Loss (unit.py:96-101, 189-236): 10 * MSE adversarial + 0.1 * KL (mean mu^2)
of the encodings + 100 * L1 identity + 0.1 * KL of the cycle encodings +
100 * L1 cycle, one Adam over the six encoder and generator modules, each
shared parameter once; then each discriminator on [real, detached
translation] with its own Adam; LambdaLR decay from ``--decay_epoch``. The
noise of each encoding is drawn from the train state's generator or passed
in. Every IN runs through the port's instance-norm kernel pair, fused with
the LeakyReLU(0.2) or ReLU after it.

The library functions take an explicit ``device``; the tests run them on the
CPU. ``run`` trains on CUDA unless told otherwise, and raises when there is
none. Under a launcher of several ranks it runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/unit.py:360-368``):
each rank loads its rows of the global batch, each encoding's noise is
drawn for the global batch and each rank keeps its rows, the losses are
global means, and rank 0 alone samples and writes checkpoints. The default
batch of 1 does not divide over the ranks and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tpugan_torch.losses import l1, mse
from tpugan_torch.models._common import sample_generator, save_grid
from tpugan_torch.models._im2im_common import first_batch, maybe_resume, out_dirs, run_per_step
from tpugan_torch.nn.im2im import ResidualBlockIN, _numbered
from tpugan_torch.nn.layers import (
    Conv2d,
    ConvTranspose2d,
    InstanceNorm,
    LeakyReLU,
    ReflectionPad,
)
from tpugan_torch.parallel.mesh import (
    auto_sharding,
    global_batch,
    global_means,
    local_rows,
    replicate_for,
)
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.optim import linear_decay_lambda
from tpugan_torch.train.state import TrainState, normalize_uint8
from tpugan_torch.utils.config import BaseConfig, config_from_args, flag

NAME = "unit"
MODULES = ("shared_E", "E1", "E2", "shared_G", "G1", "G2", "D1", "D2")
# unit.py:96-101
L0, L1_KL, L2_ID, L3_KL, L4_CYC = 10.0, 0.1, 100.0, 0.1, 100.0
INIT = "normal02"  # weights_init_normal: conv weights N(0, 0.02), torch's biases


@dataclasses.dataclass
class Config(BaseConfig):
    # Flag parity with unit.py:24-41 and tpugan.models.unit.Config.
    epoch: int = flag(0, "epoch to start training from")
    n_epochs: int = flag(200, "number of epochs of training")
    dataset_name: str = flag("apple2orange", "name of the dataset")
    batch_size: int = flag(1, "size of the batches")
    lr: float = flag(0.0001, "adam: learning rate")
    b1: float = flag(0.5, "adam: decay of first order momentum of gradient")
    b2: float = flag(0.999, "adam: decay of first order momentum of gradient")
    decay_epoch: int = flag(100, "epoch from which to start lr decay")
    n_cpu: int = flag(8, "number of cpu threads to use during batch generation")
    img_height: int = flag(256, "size of image height")
    img_width: int = flag(256, "size of image width")
    channels: int = flag(3, "number of image channels")
    sample_interval: int = flag(100, "interval between saving generator samples")
    checkpoint_interval: int = flag(-1, "interval between saving model checkpoints")
    n_downsample: int = flag(2, "number downsampling layers in encoder")
    dim: int = flag(64, "number of filters in first encoder layer")


def residual_block(features: int, generator: Optional[torch.Generator] = None):
    """unit/models.py:36-50: the CycleGAN residual block, its layers under
    ``conv_block``."""
    return ResidualBlockIN(features, generator, INIT, block_name="conv_block")


class UnitEncoder(nn.Module):
    """models.py:53-90: ``model_blocks`` (ReflectionPad(3), c7, IN +
    LeakyReLU(0.2); ``n_downsample`` stride-2 4x4 convs with IN + ReLU;
    three residual blocks), then ``shared_block``. ``forward(x, noise=None,
    generator=None, dp=None)`` returns (mu, z = mu + noise), the noise N(0,
    1) of mu's shape drawn from ``generator`` unless passed; under ``dp``
    the noise is the global batch's, drawn or passed in, and this rank's
    rows are kept."""

    def __init__(self, in_channels: int, dim: int, n_downsample: int, shared_block: nn.Module,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        layers = [(ReflectionPad(3), 1),
                  (Conv2d(in_channels, dim, 7, init_mode=INIT, generator=g), 1),
                  (InstanceNorm(act_slope=0.2), 2)]
        for _ in range(n_downsample):
            layers += [(Conv2d(dim, dim * 2, 4, 2, 1, init_mode=INIT, generator=g), 1),
                       (InstanceNorm(act_slope=0.0), 2)]
            dim *= 2
        layers += [(residual_block(dim, g), 1) for _ in range(3)]
        self.model_blocks = _numbered(layers)
        self.shared_block = shared_block

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, dp=None):
        mu = self.shared_block(self.model_blocks(x))
        if noise is None:
            shape = (global_batch(dp, mu.shape[0]), *mu.shape[1:])
            noise = torch.randn(shape, generator=generator, device=mu.device)
        return mu, mu + local_rows(dp, noise)


class UnitGenerator(nn.Module):
    """models.py:93-122: ``shared_block``, then ``model_blocks`` (three
    residual blocks; ``n_upsample`` stride-2 4x4 transposed convs with IN +
    LeakyReLU(0.2); ReflectionPad(3), c7 and tanh)."""

    def __init__(self, out_channels: int, dim: int, n_upsample: int, shared_block: nn.Module,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.shared_block = shared_block
        d = dim * 2 ** n_upsample
        layers = [(residual_block(d, g), 1) for _ in range(3)]
        for _ in range(n_upsample):
            layers += [(ConvTranspose2d(d, d // 2, 4, 2, 1, init_mode=INIT, generator=g), 1),
                       (InstanceNorm(act_slope=0.2), 2)]
            d //= 2
        layers += [(ReflectionPad(3), 1),
                   (Conv2d(d, out_channels, 7, init_mode=INIT, generator=g), 1), (nn.Tanh(), 1)]
        self.model_blocks = _numbered(layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model_blocks(self.shared_block(z))


class UnitDiscriminator(nn.Module):
    """models.py:130-154, registered as its ``model``: a stride-2 4x4 conv of
    64 filters and LeakyReLU(0.2), three more of 128, 256 and 512 with IN +
    LeakyReLU(0.2), and a plain 3x3 conv to one channel."""

    def __init__(self, channels: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        layers = [(Conv2d(channels, 64, 4, 2, 1, init_mode=INIT, generator=g), 1),
                  (LeakyReLU(0.2), 1)]
        for i, o in ((64, 128), (128, 256), (256, 512)):
            layers += [(Conv2d(i, o, 4, 2, 1, init_mode=INIT, generator=g), 1),
                       (InstanceNorm(act_slope=0.2), 2)]
        layers += [(Conv2d(512, 1, 3, 1, 1, init_mode=INIT, generator=g), 1)]
        self.model = _numbered(layers)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model(img)


@dataclasses.dataclass
class UnitState(TrainState):
    """The train state with the learning-rate schedulers, stepped once an
    epoch."""

    schedulers: dict = dataclasses.field(default_factory=dict)


def build(cfg: Config, device) -> dict:
    """The eight modules of ``MODULES``, weights drawn from a generator seeded
    by ``--seed`` (on the CPU, so they do not depend on the device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    shared_dim = cfg.dim * 2 ** cfg.n_downsample
    shared_E, shared_G = residual_block(shared_dim, gen), residual_block(shared_dim, gen)
    enc = lambda: UnitEncoder(cfg.channels, cfg.dim, cfg.n_downsample, shared_E, gen)
    dec = lambda: UnitGenerator(cfg.channels, cfg.dim, cfg.n_downsample, shared_G, gen)
    modules = {"shared_E": shared_E, "E1": enc(), "E2": enc(), "shared_G": shared_G,
               "G1": dec(), "G2": dec(), "D1": UnitDiscriminator(cfg.channels, gen),
               "D2": UnitDiscriminator(cfg.channels, gen)}
    return {k: modules[k].to(device) for k in MODULES}


def ge_parameters(modules: dict) -> list:
    """The parameters of the six encoder and generator modules, each shared
    one once: the JAX package's ``ge_tree``."""
    own = lambda m: m.model_blocks.parameters() if hasattr(m, "model_blocks") else m.parameters()
    return [p for k in MODULES[:6] for p in own(modules[k])]


def create_state(cfg: Config, modules: dict, device) -> UnitState:
    """One Adam over the encoders and generators, one for each
    discriminator, LambdaLR decay on each, and a device generator of the
    draws seeded by ``--seed``."""
    adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.b1, cfg.b2))
    opts = {"G": adam(ge_parameters(modules)), "D1": adam(modules["D1"].parameters()),
            "D2": adam(modules["D2"].parameters())}
    decay = linear_decay_lambda(cfg.n_epochs, cfg.decay_epoch, offset=cfg.epoch)
    scheds = {k: torch.optim.lr_scheduler.LambdaLR(o, decay) for k, o in opts.items()}
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return UnitState(modules, opts, draws, schedulers=scheds)


def make_step(cfg: Config, state: UnitState):
    """``step(state, a_u8, b_u8, noise=None) -> (state, out)``: one update of
    the encoders and generators, then one of D1 and of D2 (unit.py:189-258).
    ``noise`` holds the N(0, 1) of the four encodings in call order, E1(x1),
    E2(x2), E1(fake_x1), E2(fake_x2), each of mu's shape; None draws each
    from ``state.draws`` as its encoding runs; under data parallelism
    (``state.dp``) each is the global batch's, drawn or passed in, and the
    step keeps this rank's rows. ``out`` holds ``d_loss`` (D1's plus D2's)
    and ``g_loss`` as 0-d tensors (global means)."""
    E1, E2, G1, G2, D1, D2 = (state.modules[k] for k in ("E1", "E2", "G1", "G2", "D1", "D2"))
    g_params = ge_parameters(state.modules)

    def d_update(state, name, D, real, fake):
        opt = state.optimizers[name]
        opt.zero_grad(set_to_none=True)
        loss = mse(D(real), 1.0) + mse(D(fake), 0.0)
        loss.backward()
        opt.step()
        return loss.detach()

    def step(state: UnitState, a_u8, b_u8, noise=None):
        device = state.draws.device
        x1 = normalize_uint8(a_u8.to(device, non_blocking=True))
        x2 = normalize_uint8(b_u8.to(device, non_blocking=True))
        n = noise if noise is not None else [None] * 4
        dp = state.dp
        opt_g = state.optimizers["G"]
        opt_g.zero_grad(set_to_none=True)
        mu1, z1 = E1(x1, n[0], state.draws, dp)
        mu2, z2 = E2(x2, n[1], state.draws, dp)
        recon_x1, recon_x2 = G1(z1), G2(z2)
        fake_x1, fake_x2 = G1(z2), G2(z1)
        mu1_, z1_ = E1(fake_x1, n[2], state.draws, dp)
        mu2_, z2_ = E2(fake_x2, n[3], state.draws, dp)
        cycle_x1, cycle_x2 = G1(z2_), G2(z1_)
        g_loss = (
            L0 * mse(D1(fake_x1), 1.0)
            + L0 * mse(D2(fake_x2), 1.0)
            + L1_KL * torch.mean(mu1.float() ** 2)
            + L1_KL * torch.mean(mu2.float() ** 2)
            + L2_ID * l1(recon_x1, x1)
            + L2_ID * l1(recon_x2, x2)
            + L3_KL * torch.mean(mu1_.float() ** 2)
            + L3_KL * torch.mean(mu2_.float() ** 2)
            + L4_CYC * l1(cycle_x1, x1)
            + L4_CYC * l1(cycle_x2, x2)
        )
        g_loss.backward(inputs=g_params)
        opt_g.step()
        loss_d1 = d_update(state, "D1", D1, x1, fake_x1.detach())
        loss_d2 = d_update(state, "D2", D2, x2, fake_x2.detach())
        state.step += 1
        out = {"d_loss": loss_d1 + loss_d2, "g_loss": g_loss.detach()}
        return state, global_means(dp, out, tuple(out))

    return step


def make_loader(cfg: Config, device, split: str = "train", batch_size=None, prefetch: int = 2,
                dp=None):
    """Unpaired A and B (``tpugan/models/unit.py:make_loader``): folders under
    ``--data_dir``/``--dataset_name`` or synthetic domains; the training split
    with the CycleGAN jitter on both, the others with seed + 991. Under
    ``dp`` each batch is this rank's rows of the global one."""
    from tpugan_torch.data.im2im import resize_crop_flip_transform, unpaired_or_synthetic
    from tpugan_torch.data.loader import UnpairedLoader

    a, b, is_real = unpaired_or_synthetic(
        cfg.data_dir, cfg.dataset_name, cfg.img_height, cfg.img_width,
        split=split, synthetic=cfg.synthetic_data, seed=cfg.seed)
    if not is_real and split == "train":
        print("[tpugan] dataset %r not found on disk — using synthetic domains"
              % cfg.dataset_name)
    transform = (resize_crop_flip_transform(cfg.seed, cfg.img_height, cfg.img_width, indices=(0, 1))
                 if split == "train" else None)
    return UnpairedLoader(a, b, batch_size or cfg.batch_size, device,
                          seed=cfg.seed if split == "train" else cfg.seed + 991,
                          prefetch=prefetch, host_transform=transform, dp=dp)


def make_sampler(cfg: Config, modules: dict, device):
    """unit.py:150-160: five test pairs as X1, fake_X2, X2, fake_X1 on the
    batch axis, five a row, to images/<dataset>/<N>.png. The encodings' noise
    comes from a generator of the sampler's own, seeded from (``--seed``,
    batches_done), as the JAX sampler folds batches_done into its key
    (``tpugan/models/unit.py:347``): sampling leaves ``state.draws``, and so
    the training draws, as they were."""
    E1, E2, G1, G2 = (modules[k] for k in ("E1", "E2", "G1", "G2"))
    val_loader = make_loader(cfg, device, split="test", batch_size=5, prefetch=0)
    imgdir, _ = out_dirs(cfg)

    @torch.no_grad()
    def sample(state, out, batches_done):
        a_u8, b_u8 = first_batch(val_loader, batches_done)
        x1, x2 = normalize_uint8(a_u8), normalize_uint8(b_u8)
        draws = sample_generator(cfg, batches_done, x1.device)
        _, z1 = E1(x1, generator=draws)
        _, z2 = E2(x2, generator=draws)
        grid = torch.cat([x1, G2(z1), x2, G1(z2)])
        save_grid(grid, "%s/%s.png" % (imgdir, batches_done), 5)

    return sample


def run(cfg: Config, device=None) -> UnitState:
    """Train. ``device`` None means CUDA, and raises when there is none; the
    tests pass the CPU. On CUDA, float32 means TF32 off."""
    device = train_device(cfg, device)
    modules = build(cfg, device)
    maybe_resume(modules, cfg, MODULES)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, create_state(cfg, modules, device))
    return run_per_step(
        cfg, make_loader(cfg, device, dp=dp), state, make_step(cfg, state),
        make_sampler(cfg, modules, device),
        lambda out: "[D loss: %f] [G loss: %f]" % (float(out["d_loss"]), float(out["g_loss"])),
        modules, MODULES, epoch_end=lambda: [s.step() for s in state.schedulers.values()])


def main(argv=None, device=None):
    return run(config_from_args(Config, argv), device)


if __name__ == "__main__":
    main()
