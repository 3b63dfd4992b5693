"""The harness: finds a cell's files by name, times the window, takes the
traced stretch, reads the per-layer metrics and assembles the result.

A cell is driven through its configuration's ``Program``
(``configs/<config>.py``): ``setup()`` drives the checked first calls,
``next_input()`` takes the next call's batches from the port's loader,
``call(batches)`` runs the port's step or dispatch on them and
``read(out)`` reads the call's losses back to the host, one row a step;
``follow`` runs the plain reference over what the set-up recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import time
from typing import Optional

import torch

from portbench import counting, peaks, trace

HERE = os.path.dirname(os.path.abspath(__file__))
# The lower precision each cell precision is checked against (its control).
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
ELEM_SIZE = {"float32": 4, "bfloat16": 2}


def module_name(name: str) -> str:
    """A name as a Python module's: ``-`` and ``.`` written as ``_``."""
    return name.replace("-", "_").replace(".", "_")


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    chips: int
    cfg: dict  # configs/<config>.json
    traffic: dict  # workloads/<cell>.json
    spec: dict  # BENCHMARK.json

    def program_module(self):
        return importlib.import_module(f"portbench.configs.{module_name(self.config)}")

    def metrics(self, section: str) -> list:
        """The ``section``'s metrics that this cell reports: those whose
        ``workloads`` name it or that have none, and of the per-layer ones
        those that move an end-to-end metric the cell reports."""
        own = lambda m: self.name in m.get("workloads", [self.name])
        e2e = {m["name"] for m in self.spec["end_to_end"] if own(m)}
        return [m for m in self.spec[section]
                if own(m) and (section == "end_to_end" or m["moves"] in e2e)]


def load_cell(name: str, root: str = ".") -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = found[0]
    traffic = _json("workloads", f"{name}.json")
    if traffic.get("config", w["config"]) != w["config"]:
        raise SystemExit(f"portbench: workloads/{name}.json names config {traffic['config']!r}, "
                         f"BENCHMARK.json {w['config']!r}")
    return Cell(name, w["config"], w["chips"], _json("configs", f"{w['config']}.json"), traffic,
                spec)


@dataclasses.dataclass
class Window:
    steps: list  # the steps of each call
    seconds: float  # from the first call to the end of the last on the device
    input_s: list  # host seconds in next_input, a call each
    call_s: list  # host seconds in call, a call each
    losses: list  # each call's losses as read back, one row a step

    @property
    def calls(self) -> int:
        return len(self.steps)

    @property
    def total_steps(self) -> int:
        return sum(self.steps)

    def failed_steps(self) -> int:
        """Steps whose losses are not all finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.cat(self.losses)).all(dim=1)).sum())


def measure(program, seconds: float, calls: int = 0, spans=None) -> Window:
    """Calls until ``seconds`` have passed on the host clock (or, with
    ``calls``, that many), then the wait for the last: every call is
    counted whole, and the time is all of it. Each call's losses are read
    back as soon as it is issued, as the trainers' loops read them to log
    each step (``run_per_step``; ``run_training`` through ``host_rows``),
    so the next input is taken after the device has finished. ``spans``
    (a profiler's ``record_function``) names each stretch of host work."""
    span = spans or (lambda name: contextlib.nullcontext())
    steps, input_s, call_s, losses = [], [], [], []
    sync(program)
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while True:
        t0 = time.perf_counter()
        with span(trace.INPUT):
            batches = program.next_input()
        t1 = time.perf_counter()
        with span(trace.CALL):
            out = program.call(batches)
        t2 = time.perf_counter()
        with span(trace.SYNC):
            losses.append(program.read(out))
        steps.append(len(batches))
        input_s.append(t1 - t0)
        call_s.append(t2 - t1)
        if (len(steps) >= calls) if calls else (time.perf_counter() >= t_end):
            break
    sync(program)
    return Window(steps, time.perf_counter() - t_start, input_s, call_s, losses)


def sync(program) -> None:
    if program.device.type == "cuda":
        torch.cuda.synchronize(program.device)


def profiled(program, calls: int):
    """A steady profiled stretch (``trace.steady_trace``) of ``calls``
    calls driven as the window drives them (``measure``), each try from
    where the feed's pattern of calls opens (an epoch's start, where
    dispatches and eager steps alternate), so that every try holds the same
    mix."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    def once():
        while not program.aligned:
            measure(program, 0.0, calls=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                window = measure(program, 0.0, calls=calls, spans=record_function)
        return trace.reduce(prof, window.total_steps)

    return trace.steady_trace(once)


@dataclasses.dataclass
class Run:
    """What a per-layer metric reader reads."""

    cell: Cell
    kind: str  # the card's name
    window: Window
    trace: Optional[trace.Trace]
    conv_names: Optional[set]

    @property
    def dtype(self) -> str:
        return self.cell.traffic["dtype"]

    @property
    def window_steps(self) -> int:
        return self.window.total_steps

    def peak_flops(self) -> Optional[float]:
        return peaks.peak(self.kind, self.dtype)

    def in_bytes_per_step(self) -> int:
        return counting.in_bytes(self.cell.cfg["in_elements_per_step"], ELEM_SIZE[self.dtype])


IN_KERNEL = re.compile(r"\bin_act_(fwd|bwd)")


def read_metrics(run: Run, metrics: list) -> dict:
    """Each metric's reader (``metrics/<name>.py``); one that returns None
    is left out."""
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"portbench.metrics.{module_name(m['name'])}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(run: Run) -> dict:
    """The device kernels that took most time, each under its layer, and
    the longest idle gaps by the host span open at each, in seconds."""
    t = run.trace
    by = {}
    for k in t.kernels:
        if IN_KERNEL.search(k.name):
            layer = "in"
        elif run.conv_names and k.name in run.conv_names:
            layer = "conv"
        else:
            layer = "other"
        key = f"{layer}: {k.name[:120]}"
        by[key] = by.get(key, 0.0) + k.us / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps = [[name, us / 1e6] for name, us in t.idle_gaps()[:10]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card."""
    import subprocess

    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
