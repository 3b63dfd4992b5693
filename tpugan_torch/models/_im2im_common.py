"""Plumbing shared by the image-to-image trainers
(``tpugan/models/_im2im_common.py``): the ETA log line, the ``images/`` and
``saved_models/`` layout, and per-epoch ``.pth`` checkpoints with the
``--epoch N`` resume.
"""

from __future__ import annotations

import datetime
import os
import sys
import time

from tpugan_torch.io.checkpoint import load_modules, save_modules


class EtaLogger:
    """pix2pix-style single progress line with an ETA from per-batch deltas
    (pix2pix/pix2pix.py:121,178-198)."""

    def __init__(self, n_epochs: int):
        self.n_epochs = n_epochs
        self.prev_time = time.time()
        self.prev_done = 0

    def line(self, epoch, i, bpe, body: str) -> None:
        batches_done = epoch * bpe + i
        batches_left = self.n_epochs * bpe - batches_done
        now = time.time()
        n = max(batches_done - self.prev_done, 1)
        time_left = datetime.timedelta(seconds=batches_left * (now - self.prev_time) / n)
        self.prev_time = now
        self.prev_done = batches_done
        sys.stdout.write(
            "\r[Epoch %d/%d] [Batch %d/%d] %s ETA: %s"
            % (epoch, self.n_epochs, i, bpe, body, time_left)
        )
        sys.stdout.flush()


def out_dirs(cfg):
    """images/<dataset_name>/ and saved_models/<dataset_name>/ under
    output_dir, created."""
    imgdir = os.path.join(cfg.output_dir, "images", cfg.dataset_name)
    ckptdir = os.path.join(cfg.output_dir, "saved_models", cfg.dataset_name)
    os.makedirs(imgdir, exist_ok=True)
    os.makedirs(ckptdir, exist_ok=True)
    return imgdir, ckptdir


def checkpoint_epoch(modules: dict, cfg, epoch: int, names) -> None:
    """``<name>_<epoch>.pth`` (the module's ``state_dict``, written to a
    temporary file and renamed: ``io.checkpoint.save_modules``) every
    ``--checkpoint_interval`` epochs (cyclegan/cyclegan.py:279-284)."""
    if cfg.checkpoint_interval != -1 and epoch % cfg.checkpoint_interval == 0:
        _, ckptdir = out_dirs(cfg)
        save_modules(modules, ckptdir, epoch, names)


def maybe_resume(modules: dict, cfg, names) -> None:
    """``--epoch N``: load ``<name>_<N>.pth`` into each module in place
    (cyclegan/cyclegan.py:71-76); epoch 0 keeps the fresh init."""
    if cfg.epoch != 0:
        _, ckptdir = out_dirs(cfg)
        load_modules(modules, ckptdir, cfg.epoch, names)


def paired_loader(cfg, device, height: int, width: int, split: str = "train",
                  batch_size=None, prefetch: int = 2, hflip: bool = True, dp=None):
    """The paired loader of pix2pix, discogan, dualgan, munit and bicyclegan
    (``tpugan/models/pix2pix.py:make_loader``): A|B pairs from
    ``--data_dir``/``--dataset_name``, or synthetic pairs; the training split
    shuffled, with a joint horizontal flip unless ``hflip`` is False
    (bicyclegan's has none, ``tpugan/models/bicyclegan.py:365-382``), the
    others with seed + 991. Under ``dp`` each batch is this rank's rows of
    the global one, the flip drawn for the global batch."""
    from tpugan_torch.data.im2im import joint_hflip_transform, paired_or_synthetic
    from tpugan_torch.data.loader import DeviceLoader

    a, b, is_real = paired_or_synthetic(
        cfg.data_dir, cfg.dataset_name, height, width,
        split=split, synthetic=cfg.synthetic_data, seed=cfg.seed,
    )
    if not is_real and split == "train":
        print("[tpugan] dataset %r not found on disk — using synthetic pairs" % cfg.dataset_name)
    return DeviceLoader(
        [a, b], batch_size or cfg.batch_size, device, shuffle=True,
        seed=cfg.seed if split == "train" else cfg.seed + 991, prefetch=prefetch,
        host_transform=joint_hflip_transform(cfg.seed) if split == "train" and hflip else None,
        dp=dp,
    )


def first_batch(loader, epoch: int) -> tuple:
    """The first batch of ``loader``'s epoch ``epoch`` (a sampler's)."""
    batches = loader.epoch(int(epoch))
    try:
        return next(batches)
    finally:
        batches.close()


def run_per_step(cfg, loader, state, step, sample, log_body, modules: dict, names,
                 epoch_end=None):
    """The hand-rolled loop of cyclegan, munit, pix2pix, discogan, unit and
    bicyclegan (``tpugan/models/pix2pix.py:run``): one step a batch, up to
    ``--max_batches`` an epoch, from ``--epoch``; the step's scalars to
    ``--metrics_jsonl``, the ETA line with ``log_body(out)`` every
    ``--log_interval`` batches, ``sample(state, out, batches_done)`` every
    ``sample_interval``; ``epoch_end()`` (the schedulers' step) and the
    checkpoints after each epoch. Fused dispatch is not supported: the
    notice, then one step a batch. Under data parallelism every rank steps
    on its share of ``loader``'s batches (the ``dp`` the trainer gave it)
    and ``out`` holds global means; rank 0 alone logs, samples (so a
    sampler reaches no collective: ``parallel/mesh.py``) and writes
    checkpoints, each rank then waiting at a barrier."""
    import contextlib

    from tpugan_torch.parallel.mesh import is_writer, rank_zero_write
    from tpugan_torch.train.loop import StepObserver

    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    observer = StepObserver(cfg)
    step = observer.checked(step)
    eta = EtaLogger(cfg.n_epochs)
    writer = is_writer()
    for epoch in range(cfg.epoch, cfg.n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                state, out = step(state, *batch)
                batches_done = epoch * bpe + i
                observer.observe(batches_done, out)
                if writer and cfg.log_interval > 0 and i % cfg.log_interval == 0:
                    eta.line(epoch, i, bpe, log_body(out))
                if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                    rank_zero_write(lambda: sample(state, out, batches_done))
        if epoch_end is not None:
            epoch_end()
        checkpoint_epoch(modules, cfg, epoch, names)
    observer.close()
    return state
