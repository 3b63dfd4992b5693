"""The yardstick's counts: operations and bytes a training step needs,
worked out from the plain reference's shapes, whatever implements them.

``count_step(config)`` runs the configuration's reference step on the
``meta`` device (no data, no time; ``reference/<config>.py:needed_step``)
under ``torch.utils.flop_counter`` and returns

- ``flops``: the model FLOPs of the step, forward and backward, each
  gradient taken only where an update needs it (the G phase's backward
  reaches the generators' weights through the discriminators, but not the
  discriminators' weights), as the port's steps take them;
- ``conv_flops``: the part of them in convolutions and their backward;
- ``in_elements``: the elements instance norm normalizes forward and the
  elements of its input gradient backward. The IN kernels' bytes follow
  from them: forward reads x and writes y once, backward reads x and dy
  and writes dx once (``in_bytes``).

The configuration files keep these numbers (``flops_per_step``,
``conv_flops_per_step``, ``in_elements_per_step``); the tests hold the files
to this function.
"""

from __future__ import annotations

import importlib

import torch
from torch.utils.flop_counter import FlopCounterMode

CONV_OPS = ("convolution", "convolution_backward")


class _CountIN(torch.autograd.Function):
    """Identity that counts the elements entering instance norm and, in
    backward, the elements of the gradient leaving it."""

    @staticmethod
    def forward(ctx, x, tally):
        ctx.tally = tally
        tally["fwd"] += x.numel()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.tally["bwd"] += g.numel()
        return g, None


def count_step(config: str, cfg: dict) -> dict:
    """FLOPs, conv FLOPs and IN elements of one training step of ``config``
    at the sizes of ``cfg`` (the configuration file's dict)."""
    ref = importlib.import_module(
        f"portbench.reference.{config.replace('-', '_').replace('.', '_')}")
    tally = {"fwd": 0, "bwd": 0}
    counted = getattr(ref, "_in", None)
    if counted is not None:
        ref._in = lambda x: counted(_CountIN.apply(x, tally))
    try:
        with FlopCounterMode(display=False) as fc:
            ref.needed_step(cfg, "meta")
    finally:
        if counted is not None:
            ref._in = counted
    conv = sum(n for op, n in fc.get_flop_counts().get("Global", {}).items()
               if op.__name__ in CONV_OPS)
    return {"flops": fc.get_total_flops(), "conv_flops": conv, "in_elements": dict(tally)}


def in_bytes(in_elements: dict, elem_size: int) -> int:
    """Bytes the IN kernels must move for ``in_elements``: 2 accesses an
    element forward (x in, y out), 3 backward (x and dy in, dx out)."""
    return elem_size * (2 * in_elements["fwd"] + 3 * in_elements["bwd"])
