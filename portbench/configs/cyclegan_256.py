"""The port's side of ``cyclegan-256``: ``tpugan_torch.models.cyclegan``'s
``build``, ``create_state`` (Adam over both generators and one per
discriminator, LambdaLR, the two 50-image replay buffers), ``make_step``,
eager, one step a call as the trainer's own loop runs it, and
``make_loader`` (``UnpairedLoader`` on the synthetic domains, with the
train-time resize, crop and flip).

Set-up fills both 50-image replay buffers through their own
``push_and_pop`` with images drawn from the seed (``fill_images``), so
that every step, checked or timed, runs them full, as a run does from its
51st image on: each new fake swaps, on a coin from the buffers' generator,
with a stored one. The check follows the set-up's first steps (the
workload's ``check_steps``) from the seed's weights and the same fill.
"""

from __future__ import annotations

import torch

from portbench import check, shared
from portbench.check import Leg, Record

LOSSES = ("d_loss", "g_loss", "loss_GAN", "loss_cycle", "loss_identity")
FILL = 50  # cyclegan/utils.py's ReplayBuffer max_size


def fill_images(cfg: dict, seed: int, device) -> torch.Tensor:
    """(2, 50, C, H, W) images in [-1, 1), the generators' range, drawn
    from ``seed`` on ``device``: the fill of buffer A, then of buffer B."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    shape = (2, FILL, cfg["channels"], cfg["img_height"], cfg["img_width"])
    return torch.rand(shape, generator=gen, device=device) * 2 - 1


def _slot_norms(buffers: dict) -> dict:
    """``A.0`` .. ``B.49``: the norm of each image a replay buffer holds."""
    return {f"{name}.{i}": float(torch.linalg.vector_norm(img.detach().double()))
            for name, data in buffers.items() for i, img in enumerate(data)}


def _port_config(cfg: dict, traffic: dict, seed: int):
    from tpugan_torch.models import cyclegan

    keys = ("img_height", "img_width", "channels", "n_residual_blocks", "batch_size", "lr",
            "b1", "b2", "lambda_cyc", "lambda_id", "n_epochs", "decay_epoch")
    return cyclegan.Config(**{k: cfg[k] for k in keys}, synthetic_data=True, seed=seed,
                           dtype=traffic["dtype"])


class Program:
    """One training step a call; ``next_input`` gives one (A, B) batch pair
    from the loader, ``call`` steps on it, ``read`` reads its five losses
    back, as the trainer's log line does after each step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device=None, learn_conv=False):
        from tpugan_torch.models import cyclegan
        from tpugan_torch.train import loop

        laps = shared.Laps()
        pcfg = _port_config(cfg, traffic, seed)
        self.device = loop.train_device(pcfg, device)
        self.modules = cyclegan.build(pcfg, self.device)
        laps.lap("build")
        self.state = cyclegan.create_state(pcfg, self.modules, self.device)
        fill = fill_images(cfg, seed, self.device)
        for images, name in zip(fill, ("buf_A", "buf_B")):
            self.state.buffers[name].push_and_pop(images)
        laps.lap("state")
        self.probe = shared.FirstStep(cyclegan.make_step(pcfg, self.modules, self.device),
                                      self.modules, self.state.optimizers, cfg["b1"], learn_conv)
        self.check_steps = traffic["check_steps"]
        self.images_per_step = cfg["batch_size"]
        self._feed = shared.Feed(cyclegan.make_loader(pcfg, self.device), 1)
        laps.lap("loader")
        self.phases = laps.laps

    @property
    def conv_names(self):
        return self.probe.conv_names

    @property
    def aligned(self) -> bool:
        return self._feed.aligned

    def next_input(self) -> list:
        return next(self._feed)

    def call(self, batches: list) -> dict:
        (batch,) = batches
        self.state, out = self.probe(self.state, *batch)
        return out

    def read(self, out: dict) -> torch.Tensor:
        return torch.stack([out[k] for k in LOSSES]).float().cpu()[None]

    def setup(self) -> Record:
        before = check.clone(check.leaves(self.modules))
        inputs, losses = [], []
        for _ in range(self.check_steps):
            batches = self.next_input()
            inputs.append(shared.cpu(batches[0]))
            losses.append(self.read(self.call(batches)))
        losses = torch.cat(losses)
        held = _slot_norms({k[-1]: b.data for k, b in self.state.buffers.items()})
        leg = Leg(inputs, {k: losses[:, i].tolist() for i, k in enumerate(LOSSES)},
                  check.change_norms(check.leaves(self.modules), before), self.probe.grad,
                  held=held)
        return Record([leg])

    def release(self) -> None:
        self._feed.close()
        self.probe = self.state = self.modules = None


def follow(record: Record, cfg: dict, seed: int, device, precision: str) -> Record:
    """The plain reference through ``record``'s one leg, from the seed's
    weights and buffers filled as the program's, on its inputs, in
    ``precision``."""
    from portbench.reference import cyclegan_256 as ref

    modules = ref.build(cfg, seed, device)
    trainer = ref.Trainer(cfg, modules, seed, precision)
    for images, name in zip(fill_images(cfg, seed, device), ("A", "B")):
        trainer.buffers[name].push_and_pop(images)
    (leg,) = record.legs
    before = check.clone(check.leaves(modules))
    losses, grad = {k: [] for k in LOSSES}, None
    for a, b in leg.inputs:
        out = trainer.step(a, b)
        if grad is None:
            grad = check.first_grad_norms(trainer.optimizers, modules, cfg["b1"])
        for k in LOSSES:
            losses[k].append(float(out[k]))
    held = _slot_norms({k: b.data for k, b in trainer.buffers.items()})
    return Record([Leg(leg.inputs, losses, check.change_norms(check.leaves(modules), before),
                       grad, held=held)])
