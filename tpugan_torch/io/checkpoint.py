"""Crash-safe per-module checkpoints (``tpugan/io/checkpoint.py``).

Each ``<name>_<epoch>.pth`` holds a module's ``state_dict`` in the
reference's layout (cyclegan/cyclegan.py:279-284), so the reference's
``load_state_dict`` reads it. It is written to ``<path>.tmp`` in the same
directory and then renamed over ``path`` with ``os.replace``, which POSIX
makes atomic within a file system: a save that fails midway leaves the
earlier file whole and no partial file at ``path``. ``--epoch N`` resumes
from these files. Under data parallelism rank 0 alone writes, and every rank
waits at a barrier until the file is whole, so every rank can resume from it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import torch

from tpugan_torch.parallel.mesh import rank_zero_write


def save_state_dict(state_dict, path: str) -> None:
    """``torch.save(state_dict)`` to ``path + ".tmp"``, then ``os.replace``
    onto ``path``; the temporary file is removed if the save raises. On rank
    0 alone under data parallelism, then a barrier (``rank_zero_write``)."""

    def write():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        try:
            torch.save(state_dict, tmp)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    rank_zero_write(write)


def checkpoint_path(directory: str, name: str, epoch: int) -> str:
    return os.path.join(directory, "%s_%d.pth" % (name, epoch))


def save_modules(modules: Dict[str, torch.nn.Module], directory: str, epoch: int,
                 names: Iterable[str]) -> None:
    """``<name>_<epoch>.pth`` under ``directory`` for each of ``names``, each
    through ``save_state_dict``."""
    for name in names:
        save_state_dict(modules[name].state_dict(), checkpoint_path(directory, name, epoch))


def load_modules(modules: Dict[str, torch.nn.Module], directory: str, epoch: int,
                 names: Iterable[str]) -> None:
    """The ``--epoch N`` resume: ``<name>_<epoch>.pth`` into each of
    ``names`` in place, read onto the CPU and copied to the module's
    device."""
    for name in names:
        sd = torch.load(checkpoint_path(directory, name, epoch), map_location="cpu",
                        weights_only=True)
        modules[name].load_state_dict(sd)
