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

import torch


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


def checkpoint_path(ckptdir: str, name: str, epoch: int) -> str:
    return os.path.join(ckptdir, "%s_%d.pth" % (name, epoch))


def checkpoint_epoch(modules: dict, cfg, epoch: int, names) -> None:
    """``torch.save(module.state_dict())`` to ``<name>_<epoch>.pth`` every
    ``--checkpoint_interval`` epochs (cyclegan/cyclegan.py:279-284)."""
    if cfg.checkpoint_interval != -1 and epoch % cfg.checkpoint_interval == 0:
        _, ckptdir = out_dirs(cfg)
        for name in names:
            torch.save(modules[name].state_dict(), checkpoint_path(ckptdir, name, epoch))


def maybe_resume(modules: dict, cfg, names) -> None:
    """``--epoch N``: load ``<name>_<N>.pth`` into each module in place
    (cyclegan/cyclegan.py:71-76); epoch 0 keeps the fresh init."""
    if cfg.epoch != 0:
        _, ckptdir = out_dirs(cfg)
        for name in names:
            sd = torch.load(checkpoint_path(ckptdir, name, cfg.epoch), map_location="cpu",
                            weights_only=True)
            modules[name].load_state_dict(sd)
