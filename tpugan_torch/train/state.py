"""Train state and input normalisation (``tpugan/train/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpugan_torch.parallel.mesh import DataParallel


@dataclasses.dataclass
class TrainState:
    """What the steps of the MNIST-class trainers update: the modules'
    parameters and BatchNorm running statistics (through the modules), the
    optimizers' moments, and ``draws``, the device generator of the steps'
    random draws. ``step`` counts the steps taken (critic steps in the critic
    family). ``aux`` holds a trainer's loop-carried device tensors (began's
    equilibrium term ``k``, ``tpugan/models/began.py:114-186``), which the
    step updates in place so that a captured CUDA graph carries them too.
    ``dp`` is the data-parallel descriptor ``parallel.replicate_for``
    attaches, which the steps read; None in one process."""

    modules: dict
    optimizers: dict
    draws: torch.Generator
    step: int = 0
    aux: dict = dataclasses.field(default_factory=dict)
    dp: Optional[DataParallel] = None


def normalize_uint8(x: torch.Tensor, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """NHWC uint8 in, NCHW float32 ``(x/255 - mean)/std`` out, on x's device:
    batches travel as uint8 and are converted after the copy."""
    return ((x.permute(0, 3, 1, 2).float() / 255.0 - mean) / std).contiguous()
