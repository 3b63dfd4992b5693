"""Shared machinery of the n_critic Wasserstein family
(``tpugan/models/_critic_family.py``): wgan, wgan_gp and wgan_div.

Reference control flow (wgan/wgan.py:117-166, wgan_gp/wgan_gp.py:144-203):
the critic trains on every batch with a fresh z; the generator trains every
``n_critic`` batches on the same z. The host loop mirrors that schedule
around two step functions, ``d_step`` and ``g_step``; with
``--steps_per_dispatch`` K schedule units run as one ``graph_steps``
dispatch.

Random draws (z and the penalty's interpolation weights) come from the
state's ``torch.Generator`` on the device, or are passed in, so a test can
hand both frameworks the same numbers. The library functions take an explicit
device; the trainers' ``run`` asks for CUDA unless the caller names another.

Under a launcher of several ranks ``run_critic_family`` runs data-parallel
(``tpugan_torch/parallel/mesh.py``, as ``tpugan/models/_critic_family.py:
225-231``): the draws are the global batch's and each rank keeps its rows,
the losses in ``out`` are global means, and rank 0 alone logs and writes.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable

import torch

from tpugan_torch.models._common import mnist_loader as make_loader_a
from tpugan_torch.models._common import save_grid
from tpugan_torch.nn.blocks import MLPDiscriminator, MLPGenerator
from tpugan_torch.parallel.mesh import (
    auto_sharding,
    gather_rows,
    global_batch,
    global_means,
    is_writer,
    local_rows,
    rank_zero_write,
    replicate_for,
)
from tpugan_torch.train.loop import (
    StepObserver,
    _stack_batches,
    fused_k,
    graph_steps,
    host_rows,
)
from tpugan_torch.train.state import TrainState, normalize_uint8


def build_a(cfg, device) -> dict:
    """Template-A generator and critic (no sigmoid), weights drawn from a
    generator seeded by ``--seed`` (on the CPU, so they do not depend on the
    device)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    img_shape = (cfg.channels, cfg.img_size, cfg.img_size)
    modules = {
        "generator": MLPGenerator(img_shape, cfg.latent_dim, generator=gen),
        "discriminator": MLPDiscriminator(math.prod(img_shape), sigmoid=False, generator=gen),
    }
    return {k: m.to(device) for k, m in modules.items()}


def create_state_a(cfg, modules: dict, opt_g, opt_d, device) -> TrainState:
    """The optimizers as given (capturable on CUDA: ``train.optim.capturable``)
    and a device generator of the draws seeded by ``--seed``."""
    draws = torch.Generator(device=torch.device(device)).manual_seed(cfg.seed)
    return TrainState(modules, {"generator": opt_g, "discriminator": opt_d}, draws)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_d_step(cfg, modules: dict, opt_d, d_loss_fn: Callable, post_update=None,
                draw_alpha: bool = True):
    """``d_step(state, imgs_u8, labels, z=None, alpha=None) -> (state, out)``:
    one critic update (``_critic_family.py:52-102``).

    ``d_loss_fn(D, real, fake, alpha)`` is the critic loss; ``alpha`` holds
    one interpolation weight per sample, (B, 1, 1, 1). ``z`` and ``alpha``
    are drawn from ``state.draws`` in that order unless passed in;
    ``draw_alpha`` False draws no alpha (wgan_div, whose loss takes none:
    its ``alpha`` is None). wgan draws one and leaves it unused. G runs in
    train mode under ``no_grad``: its BatchNorm running statistics advance,
    as in JAX, and ``fake`` carries no graph. ``post_update(D)`` runs after
    the optimizer step (wgan's weight clip). ``out`` holds ``d_loss`` and the
    ``z`` the following g_step reuses. Under data parallelism (``state.dp``)
    z and alpha are the global batch's, drawn or passed in, and the step
    keeps this rank's rows (``out["z"]`` holds them); ``d_loss`` is the
    global mean."""
    G, D = modules["generator"], modules["discriminator"]

    def d_step(state: TrainState, imgs_u8, labels=None, z=None, alpha=None):
        del labels
        device, dp = _device(D), state.dp
        real = normalize_uint8(imgs_u8.to(device, non_blocking=True))
        b = global_batch(dp, real.shape[0])
        if z is None:
            z = torch.randn(b, cfg.latent_dim, generator=state.draws, device=device)
        if alpha is None and draw_alpha:
            alpha = torch.rand(b, 1, 1, 1, generator=state.draws, device=device)
        z = local_rows(dp, z)
        alpha = None if alpha is None else local_rows(dp, alpha)
        with torch.no_grad():
            fake = G(z)
        opt_d.zero_grad(set_to_none=True)
        d_loss = d_loss_fn(D, real, fake, alpha)
        d_loss.backward()
        opt_d.step()
        if post_update is not None:
            post_update(D)
        state.step += 1
        return state, global_means(dp, {"d_loss": d_loss.detach(), "z": z}, ("d_loss",))

    return d_step


def make_g_step(cfg, modules: dict, opt_g):
    """``g_step(state, z) -> (state, out)``: one generator update on the
    d_step's z, -mean(D(G(z))) (``_critic_family.py:105-136``). Only G's
    parameters take gradients. Under data parallelism z is this rank's rows
    (the d_step's ``out["z"]``) and ``g_loss`` the global mean."""
    G, D = modules["generator"], modules["discriminator"]
    g_params = list(G.parameters())

    def g_step(state: TrainState, z):
        opt_g.zero_grad(set_to_none=True)
        gen = G(z)
        g_loss = -D(gen).float().mean()
        g_loss.backward(inputs=g_params)
        opt_g.step()
        out = {"g_loss": g_loss.detach(), "gen_imgs": gen.detach()}
        return state, global_means(state.dp, out, ("g_loss",))

    return g_step


def make_schedule_unit(cfg, d_step, g_step):
    """One reference schedule unit as one step (``_critic_family.py:155-205``):
    the critic on ``n_critic`` consecutive batches, the generator after the
    first, on that batch's z: the host order of wgan_gp.py:144-203 (the G
    branch fires when ``i % n_critic == 0``).

    ``unit(state, imgs, labels=None)``: ``imgs`` (and ``labels``) carry a
    leading n_critic axis, one loader batch a critic step. ``out`` holds the
    first batch's ``d_loss``, ``g_loss``, the unit's ``gen_imgs`` and every
    later critic batch's ``d_loss`` as ``_d_loss<j>``, so that the fused
    loop keeps a row a loader batch. Same draws and update order as the
    unfused loop."""

    def unit(state, imgs, labels=None):
        labels = [None] * cfg.n_critic if labels is None else labels
        state, d0 = d_step(state, imgs[0], labels[0])
        state, g_out = g_step(state, d0["z"])
        out = {"d_loss": d0["d_loss"], "g_loss": g_out["g_loss"], "gen_imgs": g_out["gen_imgs"]}
        for j in range(1, cfg.n_critic):
            state, dj = d_step(state, imgs[j], labels[j])
            out["_d_loss%d" % j] = dj["d_loss"]
        return state, out

    return unit


def run_critic_family(cfg, state: TrainState, d_step, g_step, sample_inside_gstep: bool,
                      device) -> TrainState:
    """Host loop with the reference's ``batches_done`` accounting
    (``_critic_family.py:207-375``).

    sample_inside_gstep=False: wgan style (check every batch, save the latest
    G output, batches_done += 1 per batch; wgan.py:160-166).
    sample_inside_gstep=True: wgan_gp/div style (check only on G batches,
    batches_done += n_critic; wgan_gp.py:196-203).

    Samples are ``images/<batches_done>.png``: 25 images, 5 a row,
    normalized. ``--steps_per_dispatch K`` above 1 runs K schedule units
    (``make_schedule_unit``) in one ``graph_steps`` dispatch and replays the
    host's work batch by batch from the stacked scalars (``replay_units``);
    a sample takes the dispatch's last unit's images, the deviation of
    ``run_training``'s fused path. The epoch's units short of a dispatch and
    batches short of a unit run through the unfused path after the last
    replay, and so does a ragged last batch (``--ragged_last_batch``): it
    ends the epoch's filling of units. A dispatch is ``K * (n_critic + 1)``
    optimizer steps to ``--profile_steps``. ``--debug_numerics`` runs one
    batch a dispatch (``fused_k``), d_step and g_step each
    ``observer.checked``. Under a launcher of several ranks the state is
    replicated and each rank loads its share of every batch
    (``auto_sharding``); samples gather the ranks' images and rank 0 writes."""
    imgdir = os.path.join(cfg.output_dir, "images")
    os.makedirs(imgdir, exist_ok=True)
    dp = auto_sharding(cfg.batch_size, device)
    state = replicate_for(dp, state)
    loader = make_loader_a(cfg, device, dp)
    k = fused_k(cfg)
    observer = StepObserver(cfg, supports_fused_dispatch=True,
                            dispatch_steps=k * (cfg.n_critic + 1) if k > 1 else 1)
    d_step, g_step = observer.checked(d_step), observer.checked(g_step)
    steps = graph_steps(make_schedule_unit(cfg, d_step, g_step), k, dp) if k > 1 else None
    writer = is_writer()
    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    batches_done = 0
    last_gen = None

    def save(imgs, tag):
        imgs = gather_rows(dp, imgs)[:25]
        rank_zero_write(lambda: save_grid(imgs, os.path.join(imgdir, "%d.png" % tag), 5))

    def log_line(epoch, i, d_loss, g_loss):
        if not writer:
            return
        print(
            "[Epoch %d/%d] [Batch %d/%d] [D loss: %f] [G loss: %f]"
            % (
                epoch,
                cfg.n_epochs,
                (batches_done % bpe) if not sample_inside_gstep else i,
                bpe,
                float(d_loss),
                float(g_loss),
            )
        )

    def run_batch(epoch, i, batch):
        """One loader batch through the unfused path (also the fused loop's
        epoch tail)."""
        nonlocal state, batches_done, last_gen
        state, d_out = d_step(state, *batch)
        if i % cfg.n_critic != 0:
            observer.observe(epoch * bpe + i, {"d_loss": d_out["d_loss"]})
        else:
            state, g_out = g_step(state, d_out["z"])
            observer.observe(
                epoch * bpe + i, {"d_loss": d_out["d_loss"], "g_loss": g_out["g_loss"]}
            )
            last_gen = g_out["gen_imgs"]
            if cfg.log_interval > 0 and i % cfg.log_interval == 0:
                log_line(epoch, i, d_out["d_loss"], g_out["g_loss"])
            if (
                sample_inside_gstep
                and cfg.sample_interval > 0
                and batches_done % cfg.sample_interval == 0
            ):
                save(last_gen, batches_done)
        if not sample_inside_gstep:
            if (
                cfg.sample_interval > 0
                and batches_done % cfg.sample_interval == 0
                and last_gen is not None
            ):
                save(last_gen, batches_done)
            batches_done += 1
        elif i % cfg.n_critic == 0:
            batches_done += cfg.n_critic

    def replay_units(epoch, first_is, out):
        """The host's work of one fused dispatch (``_critic_family.py:308-341``):
        a telemetry row a loader batch, as the unfused loop writes them, from
        one device-to-host read of the stacked scalars; samples take the
        dispatch's last unit's images, cloned, since the next replay
        overwrites them and wgan style saves them on later batches."""
        nonlocal batches_done, last_gen
        observer.profile_tick()
        rows = host_rows(out, steps.heavy_keys, k)
        last_gen = out["gen_imgs"].clone()
        for row, i0 in zip(rows, first_is):
            for c in range(cfg.n_critic):
                r = {"d_loss": row["d_loss" if c == 0 else "_d_loss%d" % c]}
                if c == 0:
                    r["g_loss"] = row["g_loss"]
                observer.observe(epoch * bpe + i0 + c, r, dispatch=False)
            if cfg.log_interval > 0 and i0 % cfg.log_interval == 0:
                log_line(epoch, i0, row["d_loss"], row["g_loss"])
            if sample_inside_gstep:
                if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                    save(last_gen, batches_done)
                batches_done += cfg.n_critic
            else:
                for _ in range(cfg.n_critic):
                    if cfg.sample_interval > 0 and batches_done % cfg.sample_interval == 0:
                        save(last_gen, batches_done)
                    batches_done += 1

    for epoch in range(cfg.n_epochs):
        unit_buf = []  # (i, batch) filling the current schedule unit
        units = []  # (first i, [batches]) awaiting a full dispatch
        full = 0  # the epoch's batch size
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                if steps is None:
                    run_batch(epoch, i, batch)
                    continue
                unit_buf.append((i, batch))
                full = full or batch[0].shape[0]
                if batch[0].shape[0] != full:
                    break  # the ragged tail: flushed unfused below
                if len(unit_buf) < cfg.n_critic:
                    continue
                units.append((unit_buf[0][0], [b for _, b in unit_buf]))
                unit_buf = []
                if len(units) < k:
                    continue
                stacked = _stack_batches([_stack_batches(bs) for _, bs in units])
                first_is = [fi for fi, _ in units]
                units = []
                state, out = steps(state, *stacked)
                replay_units(epoch, first_is, out)
        # The fused loop's epoch tail: units short of a dispatch, then
        # batches short of a unit, a ragged one last, unfused (every fi is a
        # multiple of n_critic, so the schedule stays aligned).
        for fi, bs in units:
            for off, b in enumerate(bs):
                run_batch(epoch, fi + off, b)
        for i, b in unit_buf:
            run_batch(epoch, i, b)
    observer.close()
    return state
