"""What every configuration's module (``configs/<config>.py``) shares: the
probe around the port's step, which reads what the check needs after the
first step, and the endless feed over the port's loader."""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Iterator

import torch

from portbench import check, trace


class FirstStep:
    """``step`` itself, which on its first call (eager in every port loop:
    ``graph_steps`` runs its first dispatch eagerly) also reads the first
    gradient of every leaf from the optimizers' state (``check.first_grad_norms``)
    and, when ``learn_conv``, profiles the step to learn the names of the
    kernels that only convolution ops launch (``trace.conv_kernel_names``).
    Every later call, a CUDA-graph capture among them, passes straight
    through."""

    def __init__(self, step, modules: dict, optimizers: dict, b1: float, learn_conv: bool):
        self.step, self.modules, self.optimizers, self.b1 = step, modules, optimizers, b1
        self.learn_conv = learn_conv
        self.grad = None
        self.conv_names = None

    def __call__(self, state, *args):
        if self.grad is not None:
            return self.step(state, *args)
        if self.learn_conv:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = self.step(state, *args)
                torch.cuda.synchronize()
            self.conv_names = trace.conv_kernel_names(prof)
        else:
            out = self.step(state, *args)
        self.grad = check.first_grad_norms(self.optimizers, self.modules, self.b1)
        return out


class Feed:
    """The loader's batches, epoch after epoch, grouped into calls as the
    port's loops group them (``train.loop.run_training``): ``k`` batches a
    call, a fused dispatch, then the epoch's tail of fewer than ``k`` one
    batch a call, an eager step; with ``k`` 1 every call is one batch. An
    epoch ends after ``max_batches`` batches where that is given, as under
    ``--max_batches``. ``next()`` gives a call's list of batch tuples;
    ``at_epoch_start`` says whether the next call opens an epoch, and
``aligned`` whether it opens the pattern in which calls repeat (any call
where each is one batch, else an epoch's first). Closing
    the feed closes the loader's epoch and joins its thread."""

    def __init__(self, loader, k: int, max_batches: int = -1):
        bpe = len(loader) if max_batches < 0 else min(len(loader), max_batches)
        self.calls_per_epoch = bpe // k + bpe % k
        self.k, self.calls = k, 0
        self._calls = self._generate(loader, k, bpe)

    @staticmethod
    def _generate(loader, k: int, bpe: int) -> Iterator[list]:
        epoch = 0
        while True:
            with contextlib.closing(loader.epoch(epoch)) as batches:
                pending = []
                for batch in itertools.islice(batches, bpe):
                    pending.append(batch)
                    if len(pending) == k:
                        yield pending
                        pending = []
                for batch in pending:
                    yield [batch]
            epoch += 1

    @property
    def at_epoch_start(self) -> bool:
        return self.calls % self.calls_per_epoch == 0

    @property
    def aligned(self) -> bool:
        return self.k == 1 or self.at_epoch_start

    def __next__(self) -> list:
        self.calls += 1
        return next(self._calls)

    def close(self) -> None:
        self._calls.close()


def cpu(batch: tuple) -> tuple:
    return tuple(t.detach().cpu() for t in batch)


class Laps:
    """Host seconds of the named stages of a set-up, for the log."""

    def __init__(self):
        self.t, self.laps = time.perf_counter(), {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = round(now - self.t, 3)
        self.t = now
