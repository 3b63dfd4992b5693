"""The port's side of ``dcgan-64``: ``tpugan_torch.models.dcgan``'s
``build``, ``create_state`` (capturable Adam on CUDA, the device generator
of z and the Dropout2d masks), ``make_step`` under
``train.loop.graph_steps(step, K)`` and ``make_loader`` (the MNIST loader on
its synthetic glyphs), driven as ``train.loop.run_training`` drives them
under ``--steps_per_dispatch K``: K batches stacked to a dispatch
(``loop._stack_batches``), the epoch's tail of fewer than K one eager step
a batch, and each call's losses read back as soon as it is issued
(``loop.host_rows``).

The check follows the set-up's first two legs: the first epoch, whose
dispatch runs its K steps eagerly from the seed's weights
(``graph_steps``' warm-up) and whose tail runs eager steps, then the
second epoch's dispatch, which captures the K steps in a CUDA graph and
replays it, the path the window times. The reference follows the first
from its own weights and the second from the program's state after the
first (parameters, BatchNorm statistics, Adam's moments and step), with z
and the masks drawn from its own device generator seeded alike.
"""

from __future__ import annotations

import torch

from portbench import check, shared
from portbench.check import Leg, Record

LOSSES = ("d_loss", "g_loss")


def _port_config(cfg: dict, traffic: dict, seed: int):
    from tpugan_torch.models import dcgan

    return dcgan.Config(img_size=cfg["img_size"], batch_size=cfg["batch_size"],
                        latent_dim=cfg["latent_dim"], channels=cfg["channels"], lr=cfg["lr"],
                        b1=cfg["b1"], b2=cfg["b2"], synthetic_data=True, seed=seed,
                        dtype=traffic["dtype"])


class Program:
    """A dispatch of K steps or an eager step of the epoch's tail a call;
    ``next_input`` gives the call's batches, ``call`` runs them, ``read``
    reads their losses back, one row a step."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device=None, learn_conv=False):
        from tpugan_torch.models import dcgan
        from tpugan_torch.train import loop

        laps = shared.Laps()
        pcfg = _port_config(cfg, traffic, seed)
        self.device = loop.train_device(pcfg, device)
        self.modules = dcgan.build(pcfg, self.device)
        laps.lap("build")
        self.state = dcgan.create_state(pcfg, self.modules, self.device)
        self.probe = shared.FirstStep(dcgan.make_step(pcfg, self.state), self.modules,
                                      self.state.optimizers, cfg["b1"], learn_conv)
        self.k = traffic["steps_per_dispatch"]
        self.fused = loop.graph_steps(self.probe, self.k)
        self.images_per_step = cfg["batch_size"]
        self._feed = shared.Feed(dcgan.make_loader(pcfg, self.device), self.k,
                                 traffic.get("max_batches", -1))
        laps.lap("state and loader")
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
        from tpugan_torch.train import loop

        if len(batches) == self.k:
            self.state, out = self.fused(self.state, *loop._stack_batches(batches))
        else:
            (batch,) = batches
            self.state, out = self.probe(self.state, *batch)
        return out

    def read(self, out: dict) -> torch.Tensor:
        from tpugan_torch.train import loop

        if out[LOSSES[0]].ndim == 0:
            return torch.stack([out[k] for k in LOSSES]).float().cpu()[None]
        rows = loop.host_rows(out, self.fused.heavy_keys, self.k)
        return torch.stack([torch.stack([row[k] for k in LOSSES]) for row in rows]).float()

    def _leg(self, until_epoch: bool, grad=None, start=None) -> Leg:
        """Calls until the next epoch opens, or one call."""
        from tpugan_torch.train import loop

        before = check.clone(check.leaves(self.modules))
        inputs, losses = [], []
        while True:
            batches = self.next_input()
            inputs.append(shared.cpu(loop._stack_batches(batches)))
            losses.append(self.read(self.call(batches)))
            if not until_epoch or self._feed.at_epoch_start:
                break
        losses = torch.cat(losses)
        return Leg(inputs, {k: losses[:, i].tolist() for i, k in enumerate(LOSSES)},
                   check.change_norms(check.leaves(self.modules), before),
                   grad if grad is not None else self.probe.grad, start)

    def setup(self) -> Record:
        """The first epoch (the eager dispatch and its tail), then the
        capture and its first replay."""
        first = self._leg(until_epoch=True)
        start = check.snapshot(self.modules, self.state.optimizers)
        return Record([first, self._leg(until_epoch=False, grad={}, start=start)])

    def release(self) -> None:
        self._feed.close()
        self.fused = self.probe = self.state = self.modules = None


def follow(record: Record, cfg: dict, seed: int, device, precision: str,
           from_record: bool = True) -> Record:
    """The plain reference through ``record``'s legs on its inputs, in
    ``precision``. Each leg after the first starts from the record's state
    (``from_record``) or goes on from the reference's own, whose snapshot it
    then keeps, so that the result can stand in the program's place."""
    from portbench.reference import dcgan_64 as ref

    modules = ref.build(cfg, seed, device)
    draws = torch.Generator(device=torch.device(device)).manual_seed(seed)
    trainer = ref.Trainer(cfg, modules, draws, precision)
    legs = []
    for i, leg in enumerate(record.legs):
        start = None
        if i and from_record:
            check.restore(leg.start, modules, trainer.optimizers)
        elif i:
            start = check.snapshot(modules, trainer.optimizers)
        before = check.clone(check.leaves(modules))
        losses, grad = {k: [] for k in LOSSES}, None
        for imgs, _labels in leg.inputs:
            for batch in imgs:
                out = trainer.step(batch)
                if i == 0 and grad is None:
                    grad = check.first_grad_norms(trainer.optimizers, modules, cfg["b1"])
                for k in LOSSES:
                    losses[k].append(float(out[k]))
        legs.append(Leg(leg.inputs, losses, check.change_norms(check.leaves(modules), before),
                        grad if i == 0 else {}, start))
    return Record(legs)
