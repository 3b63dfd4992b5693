"""The port's tracing: named spans on the profiler's timeline and one store
of integer counters.

Spans are ``torch.profiler.record_function`` ranges named
``tpugan.<layer>.<what>``. A running ``torch.profiler`` (``--profile_dir``,
a benchmark's traced stretch) keeps them beside the kernels and the host
ops they enclose, on the same clock: the profiler is their store. They are
off by default, and then ``span`` returns one shared no-op context, since a
``record_function`` costs its enter and exit with no profiler running too.
``enabled()`` turns them on for a block. A span is opened and closed in one
frame and is never left open across a ``yield``. The ranges:

- ``tpugan.input.wait``: the consumer of ``DeviceLoader.epoch`` from asking
  for a batch to holding it; ``tpugan.input.to_device``: a batch's pinning
  and host-to-device copy (``DeviceLoader._to_device``, on the loader's
  thread unless the loader is synchronous);
- ``tpugan.loop.stack`` (``loop._stack_batches``), ``tpugan.loop.read``
  (``loop.host_rows``);
- ``tpugan.graph.capture``, ``tpugan.graph.copy_in``, ``tpugan.graph.replay``
  (``loop.GraphSteps``; the replay's args are its first step's index);
- ``tpugan.step`` (args: ``state.step``) with ``tpugan.step.g`` and
  ``tpugan.step.d`` inside it (``_template_b.make_step_b``,
  ``cyclegan.make_step``); ``tpugan.replay.push_and_pop``;
- ``tpugan.dispatch.<n>``: each dispatch ``--profile_dir`` traces
  (``loop.StepObserver``).

Counters are always on, one integer add a call. ``counts`` holds them by
name; a name never counted reads 0:

- ``in.fwd``/``in.bwd`` (float32) and ``in.fwd.bf16``/``in.bwd.bf16``: calls
  of the IN wrappers that launched a kernel (``ops/instance_norm.py``);
  ``adain.fwd``, ``adain.bwd`` and their ``.bf16`` twins (``ops/adain.py``);
  ``gp.fwd``, ``gp.bwd`` (``ops/mlp_gp.py``);
- ``<name>.captured`` (``in.*``, ``gp.*``): those of them made while the
  current stream was capturing a CUDA graph, each counted once however often
  its graph is replayed;
- ``graph.replays``: replays of every ``GraphSteps`` (a replay runs its K
  captured steps once);
- ``input.handoffs``: batches the threaded loader handed to its consumer;
  ``input.starved``: those of them the consumer had to wait for, its queue
  empty when it asked.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterator, Optional

import torch

_on = False
_OFF = contextlib.nullcontext()

counts: collections.Counter = collections.Counter()


def span(name: str, args: Optional[object] = None):
    """A ``record_function`` range ``name`` (``args`` as its string) while
    spans are on, else the shared no-op context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name, None if args is None else str(args))


@contextlib.contextmanager
def enabled() -> Iterator[None]:
    """Spans on inside the block, as they were after it."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def count(name: str, n: int = 1) -> None:
    counts[name] += n


def reset() -> None:
    """Every counter back to 0."""
    counts.clear()
