"""Data parallelism over ``torch.distributed`` ranks: the port of
``tpugan/parallel/mesh.py``.

The JAX package shards the global batch over a device mesh and lets GSPMD
insert the gradient all-reduce. The port runs one process a device,

    torchrun --nproc_per_node N -m tpugan_torch <model> [flags]

with the JAX package's global-batch semantics (``tpugan/parallel/mesh.py:1-16``)
for every trainer (``DP_TRAINERS``, all 32). The rule each step keeps:

- **Draws.** Every random draw is made for the global batch from
  ``state.draws``, in the single process's order and before any forward
  (``global_batch``; dropout masks drawn ahead, ``UNet.draw_masks``), and
  the step keeps this rank's contiguous rows (``local_rows``): one process
  draws the bits it drew before, the ranks' generators stay in step and no
  two ranks share a z. Each rank loads its contiguous share of each global
  batch (the loaders' ``dp``).
- **Per-sample means** stay rank-local. An optimizer step pre-hook
  averages the gradients over the ranks in one all-reduce before each
  update, where GSPMD puts its all-reduce (``replicate_for``), so the mean
  of the ranks' gradients of their means is the global mean's. No
  ``DistributedDataParallel``: a step runs D two or three times and
  differentiates a graph that holds D for G's parameters alone, which DDP's
  reducer does not support without ``find_unused_parameters``.
- **Cross-sample terms**, those that are not a mean of per-sample terms (a
  nonlinear function of a batch statistic, a sum over pairs or over the
  batch), are computed on every rank over the global batch, their input
  gathered with the differentiable ``gather_rows`` (a statistic: each rank's
  partial moments or means gathered, ``global_moments``, ``mean_over_ranks``).
  The gather's backward, ``_SumRows``, sums every rank's gradient of the
  term with respect to this rank's rows, and the hook's mean then gives
  exactly the global gradient: softmax_gan's partition (rank r's gradient
  with respect to its logits becomes ``world * dlogZ/dd_r``, and the mean
  over ranks ``sum_r dlogZ/dd_r * dd_r/dtheta``), the relativistic means
  (relativistic_gan, esrgan), ebgan's pull-away term and its hinge on the
  fakes' mean. A detached ``all_reduce`` in place of the gather gives the
  forward right and the gradient wrong. A statistic of the data alone, such
  as dragan's std of the real batch, takes no gradient. A value that steers
  every rank (began's ``k``, ebgan's hinge branch) is computed from the
  global values, so the ranks take the same branch and stay equal.
- **Norms.** BatchNorm takes its statistics over the global batch
  (``tpugan_torch/nn/layers.py:global_batch_norm``, the descriptor attached
  by ``replicate_for``), and a tracked InstanceNorm moves its running
  buffers by the global batch's mean (stargan's,
  ``tpugan_torch/nn/layers.py:InstanceNorm``); a collective's backward is a
  collective, so a penalty that differentiates a gradient through global
  BatchNorm (dualgan's) sees the global batch too. The IN and AdaIN kernels
  normalize each sample's planes and run on each rank's rows as they are.
- **Reported scalars** are global means (``global_means``).
- **Samples.** Generated images are gathered when a sample is due
  (``gather_rows``), and rank 0 alone writes images, checkpoints, metrics
  and traces, a barrier after each image and checkpoint
  (``rank_zero_write``). A sampler that runs on rank 0 alone reaches no
  collective: its networks hold no BatchNorm in training (eval mode, or
  none, or their norms on this rank's batch alone, ``nn/layers.py:
  rank_local``) and its tracked InstanceNorms are frozen
  (``batch_stats_frozen``).

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

# Every trainer of the registry runs data-parallel under a launcher.
DP_TRAINERS = ("aae", "acgan", "began", "bgan", "bicyclegan", "ccgan", "cgan", "cluster_gan",
               "cogan", "context_encoder", "cyclegan", "dcgan", "discogan", "dragan", "dualgan",
               "ebgan", "esrgan", "gan", "infogan", "lsgan", "munit", "pix2pix", "pixelda",
               "relativistic_gan", "sgan", "softmax_gan", "srgan", "stargan", "unit", "wgan",
               "wgan_div", "wgan_gp")


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
    registered on every optimizer of ``state.optimizers``. ``dp`` is also
    attached to every tracked InstanceNorm (global running buffers). ``dp``
    None leaves the state as it is."""
    if dp is None:
        return state
    from tpugan_torch.nn.layers import BatchNorm1d, BatchNorm2d, InstanceNorm

    with torch.no_grad():
        for module in state.modules.values():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t, src=0)
            for layer in module.modules():
                if isinstance(layer, (BatchNorm1d, BatchNorm2d)) or (
                        isinstance(layer, InstanceNorm) and layer.track_running_stats):
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


def global_batch(dp: Optional[DataParallel], n: int) -> int:
    """The global batch of a step whose rank holds ``n`` rows: the rows a
    step draws for, as one process would, before it keeps its own."""
    return n * (dp.world if dp else 1)


def local_rows(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a global-batch tensor (all of ``x``
    without ``dp``)."""
    if dp is None:
        return x
    n = _share(dp, x.shape[0])
    return x.narrow(0, dp.rank * n, n)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0, in rank order. Its backward is the adjoint,
    ``_SumRows``: the gathered gradient summed over the ranks, this rank's
    rows kept (the gradient of every rank's loss with respect to this rank's
    input). Each is the other's backward, so a gradient that is itself
    differentiated (a penalty's ``create_graph``) crosses the ranks again."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return _SumRows.apply(grad, ctx.dp), None


class _SumRows(torch.autograd.Function):
    """The sum over the ranks of a global-batch tensor, this rank's rows
    kept (a reduce-scatter along dim 0); its backward is ``_GatherRows``."""

    @staticmethod
    def forward(ctx, grad, dp):
        ctx.dp = dp
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return local_rows(dp, grad)

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.dp), None


def gather_rows(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor: the ranks' rows concatenated
    in rank order (``x`` itself without ``dp``). Differentiable."""
    if dp is None:
        return x
    return _GatherRows.apply(x, dp)


def mean_over_ranks(dp: Optional[DataParallel], t: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of ``t``, each rank's mean over its (equal
    share of) rows, element by element: the ranks' ``t`` gathered
    (``gather_rows``) and averaged, differentiable, so every rank's
    gradient reaches every rank's ``t``. ``t`` itself without ``dp``."""
    if dp is None:
        return t
    return gather_rows(dp, t[None]).mean(0)


def global_moments(dp: DataParallel, count: torch.Tensor, mean: torch.Tensor,
                   m2: torch.Tensor) -> tuple:
    """(n, mean, biased variance) of the global batch from each rank's
    count, mean and sum of squared deviations (tensors of one shape,
    element by element), in one differentiable all-gather (``gather_rows``)
    combined as Chan et al.'s pairwise update: no cancellation between
    E[x^2] and E[x]^2."""
    counts, means, m2s = gather_rows(dp, torch.stack([count, mean, m2])[None]).unbind(1)
    n = counts.sum(0)
    g_mean = (counts * means).sum(0) / n
    return n, g_mean, (m2s + counts * (means - g_mean).square()).sum(0) / n


def global_std(dp: Optional[DataParallel], x: torch.Tensor) -> torch.Tensor:
    """The population standard deviation (ddof 0, ``jnp.std``) of every
    element of the global batch of ``x`` (``global_moments``), in float32
    (float64 for a float64 ``x``); ``x.std(correction=0)`` without ``dp``."""
    if dp is None:
        return x.std(correction=0)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean()
    _, _, var = global_moments(dp, torch.full_like(mean, xf.numel()), mean,
                               (xf - mean).square().sum())
    return torch.sqrt(var)


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
