"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device kernels of a profiled stretch, the union of their
intervals (the device's busy time), the idle gaps between them with the
benchmark's host span that was open at each, and each kernel's layer.

The arithmetic is ``chip_smoke.py``'s (``device_kernels``, the busy share,
``_fused_times``' rule against traces that dropped events), copied here so
that the yardstick does not move with the program's scripts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

# The profiler ranges the harness opens on the host.
WINDOW, INPUT, CALL, SYNC = "portbench.window", "portbench.input", "portbench.call", "portbench.sync"
HOST_SPANS = (INPUT, CALL, SYNC)

# The aten ops whose kernels belong to the convolution layer.
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    """One profiled stretch of ``steps`` training steps."""

    kernels: list
    window: tuple  # (start_us, end_us) of the WINDOW range
    spans: list  # (name, start_us, end_us) of the host spans
    steps: int

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, names: Optional[Callable[[str], bool]] = None) -> float:
        return sum(k.us for k in self.kernels if names is None or names(k.name))

    def busy_us(self) -> float:
        """The union of the kernel intervals inside the window."""
        lo, hi = self.window
        total, end = 0.0, lo
        for k in sorted(self.kernels, key=lambda k: k.start_us):
            s, e = max(k.start_us, end), min(k.end_us, hi)
            if e > s:
                total += e - s
                end = e
        return total

    def idle_gaps(self) -> list:
        """(host span open at the gap's start, gap us) for every stretch of
        the window in which no kernel ran, longest first."""
        lo, hi = self.window
        gaps, end = [], lo
        for k in sorted(self.kernels, key=lambda k: k.start_us):
            if k.start_us > end:
                gaps.append((end, k.start_us))
            end = max(end, k.end_us)
        if hi > end:
            gaps.append((end, hi))

        def host(t):
            for name, s, e in self.spans:
                if s <= t < e:
                    return name.split(".")[-1]
            return "harness"

        return sorted(((host(s), e - s) for s, e in gaps), key=lambda g: -g[1])


def device_kernels(events) -> list:
    """The device kernels among profiler events: CUDA events without the
    user-annotation ranges, which span kernels and would count them twice,
    and without the copies and memsets, which the loader's thread issues
    whenever it runs and which the copy engines carry."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset"))]


def reduce(prof, steps: int) -> Optional[Trace]:
    """The Trace of a profiler run whose stretch sits in a WINDOW range,
    or None when the trace holds no such range."""
    events = prof.events()
    window = [e for e in events if e.name == WINDOW and e.device_type != torch.autograd.DeviceType.CUDA]
    if not window:
        return None
    w = window[0].time_range
    kernels = [Kernel(e.name, e.time_range.start, e.time_range.end) for e in device_kernels(events)
               if w.start <= e.time_range.start < w.end]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in HOST_SPANS and e.device_type != torch.autograd.DeviceType.CUDA]
    return Trace(kernels, (w.start, w.end), spans, steps)


def conv_kernel_names(prof) -> set:
    """Names of the kernels that only convolution ops launched in an eager
    profile: each op's kernels (``FunctionEvent.kernels``, which the
    profiler links by correlation id) belong to the layer when the op or
    one of its ancestors is a convolution op. A name that some other op
    launched too (a generic add or reduction) is left out, so a graph
    replay's kernels, which carry no op, can be told apart by name."""
    conv, other = set(), set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        op, under = e, False
        while op is not None and not under:
            under, op = op.name in CONV_OPS, op.cpu_parent
        (conv if under else other).update(k.name for k in e.kernels)
    return conv - other


def steady_trace(profile_once: Callable[[], Optional[Trace]], tries: int = 6):
    """``chip_smoke.py:_fused_times``' rule against traces that dropped
    events: a trace counts once another holds as many kernels within 5% of
    its device time, and no trace held more. Here "as many" allows 0.05%
    (and 2 kernels): a stretch's edges catch a kernel of the input's
    stacking more or less. Up to ``tries`` traces; where none pair, the one
    with most kernels stands, and the result says so. Returns (the trace,
    steady or not, the (kernels, device ms, seconds taken) of every try)."""
    traces, took = [], []
    close = lambda a, b, share: abs(a - b) <= share * max(a, b)
    for _ in range(tries):
        t0 = time.perf_counter()
        t = profile_once()
        if t is None:
            continue
        traces.append(t)
        took.append(time.perf_counter() - t0)
        most = max(len(x.kernels) for x in traces)
        full = sorted((x for x in traces if len(x.kernels) >= most - max(2, 5e-4 * most)),
                      key=lambda x: -len(x.kernels))
        for i, a in enumerate(full):
            for b in full[i + 1:]:
                if close(len(a.kernels), len(b.kernels), 5e-4) or abs(len(a.kernels) - len(b.kernels)) <= 2:
                    if close(a.device_us(), b.device_us(), 0.05):
                        return a, True, _tries(traces, took)
    if not traces:
        return None, False, []
    return max(traces, key=lambda x: len(x.kernels)), False, _tries(traces, took)


def _tries(traces, took) -> list:
    return [(len(x.kernels), round(x.device_us() / 1e3, 3), round(s, 1))
            for x, s in zip(traces, took)]
