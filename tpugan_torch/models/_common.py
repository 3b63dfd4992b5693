"""Shared plumbing of the MNIST-class trainers (``tpugan/models/_common.py``):
the MNIST-or-synthetic loader and the MNIST/MNIST-M pair of pixelda and
cogan, the reference's log lines, the 5x5 sample
grid, the class-grid noise of the conditional samplers and
``run_mnist_recipe``, which runs the template-A/B trainers, data-parallel
under a launcher of several ranks (``tpugan_torch/parallel/mesh.py``) as the
JAX package runs them over several devices (``tpugan/models/_common.py:104-114``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpugan_torch.data.loader import DeviceLoader, ZipLoader
from tpugan_torch.data.sources import mnist_or_synthetic, mnistm_or_synthetic
from tpugan_torch.io.images import save_image
from tpugan_torch.parallel.mesh import auto_sharding, gather_rows, rank_zero_write, replicate_for
from tpugan_torch.train.loop import Callbacks, run_training, train_device


def mnist_loader(cfg, device, dp=None) -> DeviceLoader:
    """MNIST at ``--img_size`` from ``--data_dir`` (bilinearly resized), or
    the synthetic glyphs when it is absent or ``--synthetic_data`` is set;
    batches as the JAX loader draws them, this rank's share under ``dp``."""
    ds, is_real = mnist_or_synthetic(
        cfg.data_dir,
        img_size=cfg.img_size,
        channels=cfg.channels,
        synthetic=cfg.synthetic_data,
        seed=cfg.seed,
    )
    if not is_real:
        print("[tpugan] MNIST not found on disk — using synthetic dataset")
    return DeviceLoader(
        [ds.images, ds.labels], cfg.batch_size, device, shuffle=True, seed=cfg.seed, dp=dp
    )


def two_domain_loader(cfg, device):
    """MNIST (grey, repeated to ``--channels``) zipped with MNIST-M, each
    shuffled on its own (seed and seed + 1), at ``--img_size``; synthetic
    when absent or with ``--synthetic_data`` (``tpugan/models/pixelda.py:
    make_loader``, ``tpugan/models/cogan.py:make_loader``)."""
    ds_a, is_real_a = mnist_or_synthetic(cfg.data_dir, img_size=cfg.img_size, channels=1,
                                         synthetic=cfg.synthetic_data, seed=cfg.seed)
    imgs_a = np.repeat(ds_a.images, cfg.channels, axis=-1)
    ds_b, is_real_b = mnistm_or_synthetic(cfg.data_dir, img_size=cfg.img_size,
                                          synthetic=cfg.synthetic_data, seed=cfg.seed)
    if not (is_real_a and is_real_b):
        print("[tpugan] MNIST/MNIST-M not found on disk — using synthetic data")
    return ZipLoader(
        DeviceLoader([imgs_a, ds_a.labels], cfg.batch_size, device, shuffle=True, seed=cfg.seed),
        DeviceLoader([ds_b.images, ds_b.labels], cfg.batch_size, device, shuffle=True,
                     seed=cfg.seed + 1))


def std_log_line(cfg):
    """The reference's ``[Epoch e/n] [Batch i/b] [D loss: f] [G loss: f]``;
    reading the losses waits for the step."""

    def log(epoch, i, bpe, out):
        print(
            "[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f]"
            % (epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]), float(out["g_loss"]))
        )

    return log


def acc_log_line(cfg):
    """acgan's and sgan's line, ``[D loss: f, acc: d%]`` with the step's
    ``d_acc`` (``tpugan/models/acgan.py:219-227``)."""

    def log(epoch, i, bpe, out):
        print(
            "[Epoch %d/%d] [Batch %d/%d] [D loss: %f, acc: %d%%] [G loss: %f]"
            % (epoch, cfg.n_epochs, i, bpe, float(out["d_loss"]),
               int(100 * float(out["d_acc"])), float(out["g_loss"]))
        )

    return log


def sample_generator(cfg, batches_done: int, device) -> torch.Generator:
    """A generator on ``device`` of a sampler's own, seeded from (``--seed``,
    batches_done), as the JAX samplers fold batches_done into a key they do
    not keep (``tpugan/models/cgan.py:202``): sampling leaves the training
    draws as they were."""
    seed = np.random.SeedSequence([cfg.seed, int(batches_done)]).generate_state(1, np.uint64)
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed[0]))


def sample_noise(cfg, batches_done: int, shape, device) -> torch.Tensor:
    """N(0, 1) noise of ``shape`` for the sample taken at ``batches_done``,
    from a generator of the sampler's own seeded from (``--seed``,
    batches_done), as the JAX samplers fold batches_done into a key they do
    not keep (``tpugan/models/cgan.py:202``): sampling leaves the training
    draws, ``state.draws``, as they were."""
    return torch.randn(shape, generator=sample_generator(cfg, batches_done, "cpu")).to(device)


def save_grid(imgs: torch.Tensor, path: str, nrow: int) -> None:
    """NCHW images (float32, or bf16 under ``--dtype bfloat16``) to a
    normalized PNG grid of ``nrow`` a row."""
    save_image(imgs.permute(0, 2, 3, 1).float().cpu().numpy(), path, nrow=nrow, normalize=True)


def grid_sampler(cfg):
    """``sample(state, out, batches_done)``: the first 25 images of
    ``out["gen_imgs"]`` (NCHW) as a grid of 5 a row, normalized, to
    ``images/<batches_done>.png``. Under data parallelism every rank calls
    it: the images are gathered from the ranks and rank 0 writes."""
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)

    def sample(state, out, batches_done):
        imgs = gather_rows(state.dp, out["gen_imgs"])[:25]
        rank_zero_write(lambda: save_grid(
            imgs, os.path.join(imgdir, "%d.png" % batches_done), 5))

    return sample


def run_mnist_recipe(cfg, recipe_mod, callbacks=None, device=None):
    """build -> create_state -> loader -> ``run_training``
    (``tpugan/models/_common.py:95``), with ``callbacks`` or the reference's
    log line and sample grid. ``device`` as ``train_device``. Under a
    launcher of several ranks the state is replicated and each rank loads
    its share of every batch (``auto_sharding``)."""
    device = train_device(cfg, device)
    modules = recipe_mod.build(cfg, device)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, recipe_mod.create_state(cfg, modules, device))
    loader = recipe_mod.make_loader(cfg, device, dp=dp)
    step = recipe_mod.make_step(cfg, state)
    cb = callbacks or Callbacks(log=std_log_line(cfg), sample=grid_sampler(cfg))
    return run_training(cfg, loader, state, step, cb, n_epochs=cfg.n_epochs,
                        sample_interval=cfg.sample_interval)
