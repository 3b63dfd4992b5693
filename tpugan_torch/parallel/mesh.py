"""Data parallelism over ``torch.distributed`` ranks: the port of
``tpugan/parallel/mesh.py``.

The JAX package shards the global batch over a device mesh and lets GSPMD
insert the gradient all-reduce. The port runs one process a device,

    torchrun --nproc_per_node N -m tpugan_torch <model> [flags]

with the JAX package's global-batch semantics (``tpugan/parallel/mesh.py:1-16``):

- every rank takes a contiguous share of each global batch (the loaders'
  ``dp``) and of each random draw: a step draws for the global batch from
  its generator, as one process would, and keeps its rows (``local_rows``),
  so the ranks' generators stay in step and never share a z;
- BatchNorm takes its statistics over the global batch
  (``tpugan_torch/nn/layers.py:global_batch_norm``, the descriptor attached
  by ``replicate_for``);
- a loss is a mean over the rank's rows, so the mean of the ranks' losses is
  the global mean, and so is the mean of their gradients: an optimizer step
  pre-hook averages the gradients over the ranks in one all-reduce before
  each update, where GSPMD puts its all-reduce (``replicate_for``). No
  ``DistributedDataParallel``: a step runs D two or three times and
  differentiates a graph that holds D for G's parameters alone, which DDP's
  reducer does not support without ``find_unused_parameters``;
- the scalars a step reports are global means (``global_means``); the
  generated images are gathered when a sample is due (``gather_rows``).

Rank 0 alone writes images, checkpoints, metrics and traces, and a barrier
follows each image and checkpoint (``rank_zero_write``).

Two deviations from the JAX package, both of the launch model: the JAX
package turns data parallelism on whenever more than one device is visible,
where a process of the port sees only its own rank and needs a launcher (a
process without one that sees several CUDA devices says so,
``tpugan_torch/__main__.py``); and under a launcher an indivisible batch
raises, where the JAX package falls back to one device (N processes cannot
become one).

The collectives run on the default group: NCCL on CUDA, gloo on the CPU, or
whatever group the caller initialized before (the tests and ``chip_smoke.py``
make their own). Under NCCL, ``--steps_per_dispatch`` above 1 captures the
collectives in the CUDA graph with the steps; gloo's are host calls, which a
graph cannot hold, so ``check_fusable`` refuses that pairing.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

# The trainers ported to data parallelism, and for each other trainer the
# ROADMAP item that ports it (queue 1, item 9's later slices).
DP_TRAINERS = ("dcgan", "gan", "lsgan", "bgan", "wgan", "wgan_gp", "wgan_div", "cyclegan")
_LATER = {
    **{n: "ROADMAP queue 1, item 9b (the batch-local MNIST-class trainers)"
       for n in ("cgan", "acgan", "infogan", "sgan", "aae", "cluster_gan", "ccgan",
                 "context_encoder", "cogan", "pixelda")},
    **{n: "ROADMAP queue 1, item 9c (the trainers with a cross-sample term)"
       for n in ("softmax_gan", "relativistic_gan", "esrgan", "ebgan", "began", "dragan")},
    **{n: "ROADMAP queue 1, item 9d (the im2im, style and SR trainers)"
       for n in ("pix2pix", "discogan", "dualgan", "stargan", "unit", "munit", "bicyclegan",
                 "srgan")},
}


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A step's data-parallel descriptor: this process's rank in the default
    process group and the group's size."""

    rank: int
    world: int


def launched_world() -> int:
    """``WORLD_SIZE`` as a launcher (``torchrun``) sets it; 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def in_data_parallel() -> bool:
    """Whether this process runs under a launcher of more than one rank or
    inside a process group."""
    return launched_world() > 1 or dist.is_initialized()


def refuse_outside_slice(cfg) -> None:
    """Raise NotImplementedError for a trainer not yet ported to data
    parallelism (its ``Config``'s module names it) when this process runs
    under a launcher of more than one rank or inside a process group: no
    trainer runs rank-local semantics silently."""
    name = type(cfg).__module__.rsplit(".", 1)[-1]
    if in_data_parallel() and name in _LATER:
        raise NotImplementedError(
            f"{name} is not ported to data parallelism yet ({_LATER[name]}); run it as one "
            f"process. Ported: {', '.join(DP_TRAINERS)}")


def _check_divisible(batch_size: int, world: int) -> None:
    if batch_size % world:
        raise ValueError(
            f"[tpugan] batch_size={batch_size} is not divisible by the {world} data-parallel "
            f"ranks; {world} processes cannot run as one device. Use a global batch that is a "
            f"multiple of {world}.")


def auto_sharding(batch_size: int, device) -> Optional[DataParallel]:
    """The data-parallel descriptor of a run (``tpugan/parallel/mesh.py:49-68``),
    or None for one process.

    - Inside a process group the caller made: that group, as it is, whatever
      its size.
    - Under a launcher of more than one rank (``WORLD_SIZE``): the default
      group, initialized here from the launcher's environment, NCCL for a
      CUDA ``device`` and gloo for the CPU.
    - Otherwise None. When the batch does not divide over the CUDA devices
      this process sees, the JAX package's warning (it would run on one
      device; the port always does without a launcher).

    A batch that does not divide over more than one rank raises ValueError."""
    device = torch.device(device)
    if not dist.is_initialized():
        world = launched_world()
        if world <= 1:
            n = torch.cuda.device_count() if device.type == "cuda" else 1
            if n > 1 and batch_size % n:
                warnings.warn(
                    f"[tpugan] batch_size={batch_size} is not divisible by the {n}-device "
                    f"mesh — running SINGLE-DEVICE. Use a global batch that is a multiple of "
                    f"{n} to enable data parallelism.",
                    stacklevel=2,
                )
            return None
        _check_divisible(batch_size, world)
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    world = dist.get_world_size()
    if world > 1:
        _check_divisible(batch_size, world)
    return DataParallel(dist.get_rank(), world)


def _average_grads(dp: DataParallel) -> Callable:
    """An optimizer step pre-hook: the mean over the ranks of the gradients
    of the optimizer's parameters, in one all-reduce of their concatenation.
    A parameter without a gradient is skipped; which ones have none depends
    on the step's code alone, so it is the same set on every rank."""

    def hook(optimizer, args, kwargs):
        grads = [p.grad for group in optimizer.param_groups for p in group["params"]
                 if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(dp.world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    return hook


def replicate_for(dp: Optional[DataParallel], state):
    """Replicate a train state over the ranks (``tpugan/parallel/mesh.py:71-76``):
    rank 0's parameters and buffers broadcast to every rank; ``dp`` attached
    to every BatchNorm of ``state.modules`` (global statistics) and to the
    state (``state.dp``, which the steps read); the gradient average
    registered on every optimizer of ``state.optimizers``. ``dp`` None
    leaves the state as it is."""
    if dp is None:
        return state
    from tpugan_torch.nn.layers import BatchNorm1d, BatchNorm2d

    with torch.no_grad():
        for module in state.modules.values():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t, src=0)
            for layer in module.modules():
                if isinstance(layer, (BatchNorm1d, BatchNorm2d)):
                    layer.dp = dp
                elif isinstance(layer, torch.nn.modules.batchnorm._BatchNorm):
                    raise TypeError(f"{type(layer).__name__} takes per-rank statistics; the "
                                    "port's BatchNorm1d/BatchNorm2d take global ones")
    for opt in state.optimizers.values():
        opt.register_step_pre_hook(_average_grads(dp))
    state.dp = dp
    if dp.rank == 0:
        print("[tpugan] data-parallel over %d devices" % dp.world)
    return state


def check_fusable(dp: Optional[DataParallel]) -> None:
    """Raise NotImplementedError for ``--steps_per_dispatch`` above 1 over a
    gloo group: gloo's collectives are host calls, which a CUDA graph cannot
    capture (NCCL's are device work, captured with the steps)."""
    if dp is not None and dist.get_backend() == "gloo":
        raise NotImplementedError(
            "--steps_per_dispatch above 1 under data parallelism needs NCCL: gloo's "
            "collectives are host calls, which a CUDA graph cannot capture; run one step a "
            "dispatch")


def _share(dp: DataParallel, n: int) -> int:
    if n % dp.world:
        raise ValueError(f"{n} rows do not divide over {dp.world} ranks")
    return n // dp.world


def local_rows(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a global-batch tensor (all of ``x``
    without ``dp``)."""
    if dp is None:
        return x
    n = _share(dp, x.shape[0])
    return x.narrow(0, dp.rank * n, n)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0, in rank order. Its backward sums the
    gathered gradient over the ranks and keeps this rank's rows: the
    gradient of every rank's loss with respect to this rank's input."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return local_rows(ctx.dp, grad), None


def gather_rows(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor: the ranks' rows concatenated
    in rank order (``x`` itself without ``dp``). Differentiable."""
    if dp is None:
        return x
    return _GatherRows.apply(x, dp)


def global_mean(dp: Optional[DataParallel], t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of ``t`` (each rank's mean over its rows),
    element by element, detached; ``t`` detached without ``dp``."""
    t = t.detach()
    if dp is None:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / dp.world


def global_means(dp: Optional[DataParallel], out: dict, names) -> dict:
    """``out`` with its 0-d entries ``names`` replaced by their global means,
    in one all-reduce; ``out`` unchanged without ``dp``."""
    if dp is None:
        return out
    means = global_mean(dp, torch.stack([out[n].float() for n in names]))
    return {**out, **dict(zip(names, means.unbind()))}


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 of its process
    group, or a process in none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_zero_write(write: Callable[[], None]) -> None:
    """``write()`` on rank 0 alone, then a barrier, so no rank reads a file
    before it is whole; ``write()`` alone outside a process group."""
    if is_writer():
        write()
    if dist.is_initialized():
        dist.barrier()
