"""Training-loop plumbing (``tpugan/train/loop.py:74-186``): the per-step
metrics sink and a minimal step observer.

The port runs one optimizer step per Python iteration. Flags of the JAX
package that the port does not carry yet are refused here, where every loop
starts, with the ROADMAP item that ports them.
"""

from __future__ import annotations

import json

_UNPORTED = {
    "profile_dir": "ROADMAP queue 1, item 10 (metrics, IO, CLI: torch.profiler)",
    "profile_port": "ROADMAP queue 1, item 10 (metrics, IO, CLI: torch.profiler)",
    "debug_numerics": "ROADMAP queue 1, item 10 (metrics, IO, CLI)",
    "ragged_last_batch": "ROADMAP queue 1, item 10 (metrics, IO, CLI)",
}
_BF16_ITEM = "ROADMAP queue 1, item 7 (bf16)"


def reject_unported_flags(cfg) -> None:
    """Raise NotImplementedError for a flag set away from its default that
    the port does not implement yet."""
    for name, item in _UNPORTED.items():
        if getattr(cfg, name, None):
            raise NotImplementedError(f"--{name} is not ported yet: {item}")
    if getattr(cfg, "dtype", "float32") != "float32":
        raise NotImplementedError(f"--dtype {cfg.dtype} is not ported yet: {_BF16_ITEM}")


class MetricsSink:
    """jsonl per-step scalar sink: one line ``{"step": N, name: value, ...}``
    for each observed step, from a dict of scalars (0-d tensors). Reading a
    CUDA scalar waits for the step."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def write(self, step: int, out: dict) -> None:
        rec = {"step": step, **{k: float(v) for k, v in out.items()}}
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
