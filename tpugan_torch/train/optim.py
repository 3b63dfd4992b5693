"""Optimizers of the port (``tpugan/train/optim.py``). The optimizers
themselves are ``torch.optim.Adam`` (bias-corrected moments with eps 1e-8
outside the sqrt, which ``adam_torch`` reproduces in optax) and
``torch.optim.RMSprop`` (eps outside the sqrt, which ``rmsprop_torch``
reproduces); here are the keyword that makes them capturable in a CUDA
graph, the weight clip and the learning-rate schedule."""

from __future__ import annotations

import torch


def capturable(device) -> dict:
    """``capturable=True`` on CUDA, where ``graph_steps`` may capture the
    step, and in the eager steps too, so that both do the same arithmetic;
    nothing on the CPU, which does not support it."""
    return {"capturable": True} if torch.device(device).type == "cuda" else {}


@torch.no_grad()
def clip_params_(module: torch.nn.Module, clip_value: float) -> None:
    """WGAN weight clipping (wgan/wgan.py:139-141, ``clip_params``): clamp
    every parameter to [-clip_value, clip_value] in place, after the
    optimizer step."""
    for p in module.parameters():
        p.clamp_(-clip_value, clip_value)


def linear_decay_lambda(n_epochs: int, decay_start_epoch: int, offset: int = 0):
    """The LambdaLR factor of cyclegan/utils.py:36-44, ``1 - max(0, epoch +
    offset - decay_start) / (n_epochs - decay_start)``, floored at 0 as
    ``linear_decay_schedule`` floors it: past ``n_epochs`` the reference's
    factor turns negative and every update into gradient ascent. Step the
    LambdaLR once per epoch."""

    def factor(epoch: int) -> float:
        frac = max(0, epoch + offset - decay_start_epoch) / (n_epochs - decay_start_epoch)
        return max(0.0, 1.0 - frac)

    return factor
