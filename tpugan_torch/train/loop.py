"""Training-loop plumbing (``tpugan/train/loop.py:74-286``): the per-step
metrics sink, a minimal step observer, the trainers' device, and the generic
loop ``run_training``.

The port runs one optimizer step per Python iteration. Flags of the JAX
package that the port does not carry yet are refused here, where every loop
starts, with the ROADMAP item that ports them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Callable, Optional

import torch

_UNPORTED = {
    "profile_dir": "ROADMAP queue 1, item 10 (metrics, IO, CLI: torch.profiler)",
    "profile_port": "ROADMAP queue 1, item 10 (metrics, IO, CLI: torch.profiler)",
    "debug_numerics": "ROADMAP queue 1, item 10 (metrics, IO, CLI)",
    "ragged_last_batch": "ROADMAP queue 1, item 10 (metrics, IO, CLI)",
}
_BF16_ITEM = "ROADMAP queue 1, item 8 (bf16)"


def reject_unported_flags(cfg) -> None:
    """Raise NotImplementedError for a flag set away from its default that
    the port does not implement yet."""
    for name, item in _UNPORTED.items():
        if getattr(cfg, name, None):
            raise NotImplementedError(f"--{name} is not ported yet: {item}")
    if getattr(cfg, "dtype", "float32") != "float32":
        raise NotImplementedError(f"--dtype {cfg.dtype} is not ported yet: {_BF16_ITEM}")


def train_device(cfg, device=None) -> torch.device:
    """The device a trainer's ``run`` trains on: CUDA when ``device`` is
    None, raising when there is none (the tests pass the CPU). Refuses the
    unported flags. On CUDA, float32 means TF32 off for convolutions and
    matmuls."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("tpugan_torch trains on CUDA and found no CUDA device")
        device = torch.device("cuda")
    device = torch.device(device)
    reject_unported_flags(cfg)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


class MetricsSink:
    """jsonl per-step scalar sink: one line ``{"step": N, name: value, ...}``
    for each observed step, from the scalars (0-d tensors or numbers) of a
    dict; other entries, such as the generated images, are left out. Reading
    a CUDA scalar waits for the step."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def write(self, step: int, out: dict) -> None:
        rec = {"step": step, **{k: float(v) for k, v in out.items()
                                if getattr(v, "ndim", 0) == 0}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class StepObserver:
    """Wires ``--metrics_jsonl`` into a training loop. ``--steps_per_dispatch``
    above 1 prints the JAX package's notice and the loop runs one step at a
    time."""

    def __init__(self, cfg):
        if getattr(cfg, "steps_per_dispatch", 1) > 1:
            print(
                "[tpugan] --steps_per_dispatch is not supported by this "
                "recipe's training loop (per-step host logic); running "
                "one step per dispatch"
            )
        path = getattr(cfg, "metrics_jsonl", "")
        self.sink = MetricsSink(path) if path else None

    def observe(self, batches_done: int, out: dict) -> None:
        if self.sink is not None:
            self.sink.write(batches_done, out)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


@dataclasses.dataclass
class Callbacks:
    # log(epoch, batch_idx, batches_per_epoch, out_dict)
    log: Optional[Callable[[int, int, int, dict], None]] = None
    # sample(state, out_dict, batches_done)
    sample: Optional[Callable[[Any, dict, int], None]] = None


def run_training(cfg, loader, state, step_fn, callbacks: Callbacks, n_epochs: int,
                 sample_interval: int = 0):
    """The generic loop of ``tpugan/train/loop.py:run_training``, one
    optimizer step per iteration: ``state, out = step_fn(state, *batch)`` for
    each batch, up to ``--max_batches`` an epoch; ``out`` goes to
    ``--metrics_jsonl``, to ``callbacks.log`` every ``--log_interval``
    batches and to ``callbacks.sample`` whenever ``batches_done`` (epoch *
    batches an epoch + batch) is a multiple of ``sample_interval``."""
    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    observer = StepObserver(cfg)
    for epoch in range(n_epochs):
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                state, out = step_fn(state, *batch)
                batches_done = epoch * bpe + i
                observer.observe(batches_done, out)
                if callbacks.log and cfg.log_interval > 0 and i % cfg.log_interval == 0:
                    callbacks.log(epoch, i, bpe, out)
                if (callbacks.sample and sample_interval > 0
                        and batches_done % sample_interval == 0):
                    callbacks.sample(state, out, batches_done)
    observer.close()
    return state
