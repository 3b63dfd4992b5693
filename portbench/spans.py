"""The port's own spans and counters in a second profiled stretch, read by
the per-layer metrics that split the card's idle time by the host work of
the port (``tpugan_torch/utils/tracing.py``).

Under ``--trace 1`` the first of these metrics to be read takes a second
stretch after the harness's own (``harness.profiled``): the same
``profile_calls`` calls, driven by ``harness.measure`` from the same aligned
start and kept by the same ``trace.steady_trace`` rule, with the port's
spans on (``tracing.enabled()``). As in the harness's stretch, only the main
thread's host ranges are profiled: profiling every thread would slow the
loader's thread, whose hand-off the metrics read. Of its trace it keeps the
kernels and the window as ``trace.reduce`` does, the ``tpugan.*`` ranges of
the main thread (the thread of the window's range) and the deltas of
``tracing.counts`` over the stretch. Each stretch of the window in which
no kernel ran is split over the innermost ``tpugan.*`` range open on the
main thread at each instant; what no range covers is the harness's. The
split goes to standard error in ms a step.

The harness hands a reader the Run, not the program: the program is the
cell's one live ``Program`` (``configs/<config>.py``) that ``release()`` has
not emptied, since the harness releases it only after the readers. A port
without ``tpugan_torch.utils.tracing`` has nothing here to read, and the
metrics are left out; a port with it whose run holds no such program, or
two, is a fault of the search, and raises.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import sys
from typing import Optional

import torch

from portbench import harness, trace

PREFIX = "tpugan."
HARNESS = "harness"
INPUT_WAIT, STACK = "tpugan.input.wait", "tpugan.loop.stack"
STEP, GRAPH = "tpugan.step", "tpugan.graph."


@dataclasses.dataclass
class SpanTrace(trace.Trace):
    """A profiled stretch with the port's spans on."""

    ranges: list  # (name, start_us, end_us) of the main thread's tpugan.* ranges
    counts: dict  # tracing.counts' deltas over the stretch

    def ms_per_step(self, us: float) -> float:
        return us / 1e3 / self.steps

    def span_us(self, name: str) -> float:
        """The summed length of the ranges ``name``."""
        return sum(e - s for n, s, e in self.ranges if n == name)

    def idle_intervals(self) -> list:
        """(start_us, end_us) of each stretch of the window in which no
        kernel ran: the window less the union of the kernel intervals
        (``Trace.busy_us``)."""
        lo, hi = self.window
        gaps, end = [], lo
        for k in sorted(self.kernels, key=lambda k: k.start_us):
            if k.start_us > end:
                gaps.append((end, k.start_us))
            end = max(end, k.end_us)
        if hi > end:
            gaps.append((end, hi))
        return gaps

    @functools.cached_property
    def split(self) -> "IdleSplit":
        """The idle time by the innermost range open at each instant, by the
        ranges open at all, and under ``tpugan.step`` outside any
        ``tpugan.graph.*`` range (an eager step's), in us."""
        points = [(s, 0, 1, i) for i, (_, s, _) in enumerate(self.ranges)]
        points += [(e, 1, -1, i) for i, (_, _, e) in enumerate(self.ranges)]
        gaps = self.idle_intervals()
        points += [(s, 0, 1, None) for s, _ in gaps] + [(e, 1, -1, None) for _, e in gaps]
        points.sort(key=lambda p: (p[0], p[1]))
        innermost, under, eager = {}, {}, 0.0
        open_, idle, last = [], 0, self.window[0]
        for t, _, delta, i in points:
            if idle and t > last:
                dt = t - last
                names = [self.ranges[j][0] for j in open_]
                # Ranges of one thread nest: the one opened last is innermost.
                key = names[-1] if names else HARNESS
                innermost[key] = innermost.get(key, 0.0) + dt
                for n in set(names):
                    under[n] = under.get(n, 0.0) + dt
                if STEP in names and not any(n.startswith(GRAPH) for n in names):
                    eager += dt
            last = t
            if i is None:
                idle += delta
            elif delta > 0:
                open_.append(i)
            else:
                open_.remove(i)
        return IdleSplit(innermost, under, eager)


@dataclasses.dataclass
class IdleSplit:
    innermost: dict  # name (or HARNESS): idle us with it the innermost range
    under: dict  # name: idle us with a range of that name open
    eager: float  # idle us in eager steps


def live_program(run):
    """The cell's one program that the harness has not released."""
    cls = run.cell.program_module().Program
    found = [o for o in gc.get_objects() if type(o) is cls and o.state is not None]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} live {cls.__module__}.Program objects, not one: "
                           "no program to take the span stretch from")
    return found[0]


def _main_ranges(events, window_event) -> list:
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith(PREFIX) and e.device_type != torch.autograd.DeviceType.CUDA
            and e.thread == window_event.thread
            and window_event.time_range.start <= e.time_range.start < window_event.time_range.end]


def stretch(program, calls: int):
    """The second stretch (the module's docstring): (SpanTrace or None,
    steady or not, the tries), as ``trace.steady_trace`` gives them."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from tpugan_torch.utils import tracing

    activities = [ProfilerActivity.CPU]
    if program.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def once():
        while not program.aligned:
            harness.measure(program, 0.0, calls=1)
        before = dict(tracing.counts)
        with tracing.enabled(), profile(activities=activities) as prof:
            with record_function(trace.WINDOW):
                window = harness.measure(program, 0.0, calls=calls, spans=record_function)
        t = trace.reduce(prof, window.total_steps)
        if t is None:
            return None
        events = prof.events()
        (w,) = [e for e in events
                if e.name == trace.WINDOW and e.device_type != torch.autograd.DeviceType.CUDA]
        counts = {k: v - before.get(k, 0) for k, v in tracing.counts.items()}
        return SpanTrace(**vars(t), ranges=_main_ranges(events, w), counts=counts)

    return trace.steady_trace(once)


_last: Optional[tuple] = None  # (run, its SpanTrace or None)


def of(run) -> Optional[SpanTrace]:
    """The run's second stretch, taken on the first call and logged; None
    where the run was not traced or the port has no tracing module."""
    global _last
    if _last is not None and _last[0] is run:
        return _last[1]
    _last = (run, None)
    if run.trace is None:
        return None
    try:
        import tpugan_torch.utils.tracing  # noqa: F401
    except ImportError:
        return None
    program = live_program(run)
    t, steady, tries = stretch(program, run.cell.traffic["profile_calls"])
    log(f"span stretches (kernels, device ms, s): {tries}; "
        + ("two agree" if steady else "none agree: the most complete stands"))
    if t is not None:
        log_split(t)
    _last = (run, t)
    return t


def log_split(t: SpanTrace) -> None:
    split = t.split
    ms = lambda us: round(t.ms_per_step(us), 5)
    idle = t.window_us - t.busy_us()
    parts = sorted(split.innermost.items(), key=lambda kv: -kv[1])
    log(f"idle by innermost span, ms/step over {t.steps} steps: "
        + ", ".join(f"{n} {ms(us)}" for n, us in parts)
        + f"; eager steps {ms(split.eager)}; idle {ms(idle)} ms/step "
        f"({100.0 * idle / t.window_us:.3f}% of the stretch), the split sums to "
        f"{ms(sum(split.innermost.values()))}; counts {dict(sorted(t.counts.items()))}")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)
