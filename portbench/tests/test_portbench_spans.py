"""The span stretch and its six readers (``portbench/spans.py``): each
reader on a synthetic trace whose kernels, idle stretches and port ranges
are known, a range covering part of a gap among them; nothing to read on a
port without its tracing module, and a fault where the port has one but the
run holds no program; the stretch itself, and a whole traced run through
``run.main``, on the CPU at a small size.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import sys
import types

import pytest
import torch

from portbench import harness, run, spans
from portbench.trace import Kernel

READERS = ("loader_wait_ms", "loader_starved_share", "idle_in_input_ms", "stack_ms",
           "idle_in_stack_ms", "idle_in_eager_ms")


def synthetic() -> spans.SpanTrace:
    """A window of 60 us and 2 steps; kernels at 10-20 and 30-40, so the
    device idles 0-10, 20-30 and 40-60 (40 us). The loader's wait (0-12)
    outlasts its gap, the stacking (20-25) and the copy-in (25-27) cover
    part of theirs, 27-30 is the harness's; an eager step 40-50 with its G
    phase at 42-46, then a capture 50-60 whose step (52-58) is no eager
    step."""
    ranges = [("tpugan.input.wait", 0, 12), ("tpugan.loop.stack", 20, 25),
              ("tpugan.graph.copy_in", 25, 27), ("tpugan.step", 40, 50),
              ("tpugan.step.g", 42, 46), ("tpugan.graph.capture", 50, 60),
              ("tpugan.step", 52, 58)]
    return spans.SpanTrace(kernels=[Kernel("k", 10.0, 20.0), Kernel("k", 30.0, 40.0)],
                           window=(0.0, 60.0), spans=[], steps=2, ranges=ranges,
                           counts={"input.handoffs": 4, "input.starved": 3})


def test_the_split_covers_the_idle_time_by_the_innermost_range():
    t = synthetic()
    assert t.idle_intervals() == [(0.0, 10.0), (20.0, 30.0), (40.0, 60.0)]
    assert t.split.innermost == {"tpugan.input.wait": 10.0, "tpugan.loop.stack": 5.0,
                                 "tpugan.graph.copy_in": 2.0, "harness": 3.0,
                                 "tpugan.step": 12.0, "tpugan.step.g": 4.0,
                                 "tpugan.graph.capture": 4.0}
    assert sum(t.split.innermost.values()) == t.window_us - t.busy_us() == 40.0
    assert t.split.under["tpugan.step"] == 16.0 and t.split.eager == 10.0


@pytest.mark.parametrize("name, want", [
    ("loader_wait_ms", 12 / 2 / 1e3),  # the whole wait, busy part included
    ("loader_starved_share", 75.0),
    ("idle_in_input_ms", 10 / 2 / 1e3),
    ("stack_ms", 5 / 2 / 1e3),
    ("idle_in_stack_ms", 5 / 2 / 1e3),
    ("idle_in_eager_ms", 10 / 2 / 1e3),  # the G phase's idle in, the captured step's out
])
def test_each_reader_on_the_synthetic_trace(name, want, monkeypatch):
    t = synthetic()
    monkeypatch.setattr(spans, "of", lambda run: t)
    reader = importlib.import_module(f"portbench.metrics.{name}")
    assert reader.read(types.SimpleNamespace()) == pytest.approx(want, rel=1e-12)


def test_nothing_to_read_without_the_ports_tracing(monkeypatch):
    run = types.SimpleNamespace(trace=object())
    monkeypatch.setitem(sys.modules, "tpugan_torch.utils.tracing", None)  # import fails
    for name in READERS:
        assert importlib.import_module(f"portbench.metrics.{name}").read(run) is None
    assert spans.of(types.SimpleNamespace(trace=None)) is None


def test_a_port_with_tracing_but_no_live_program_raises():
    class Program:  # never made
        pass

    cell = types.SimpleNamespace(program_module=lambda: types.SimpleNamespace(Program=Program))
    with pytest.raises(RuntimeError, match="0 live"):
        spans.of(types.SimpleNamespace(trace=object(), cell=cell))


def test_the_stretch_on_the_cpu_records_the_ports_ranges_and_counts(bench_root):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cell = harness.load_cell("dcgan-64.graphed", bench_root)
    cell.cfg.update({"img_size": 16, "batch_size": 8})
    cell.traffic.update({"steps_per_dispatch": 3, "max_batches": 5})
    program = cell.program_module().Program(cell.cfg, cell.traffic, 2_200_000_017, "cpu")
    try:
        program.setup()
        t, steady, tries = spans.stretch(program, 4)
    finally:
        program.release()
        torch.set_num_threads(threads)
    assert steady and t.steps == 8  # an epoch (a dispatch of 3, a tail of 2) and a dispatch
    names = {n for n, _, _ in t.ranges}
    assert {"tpugan.input.wait", "tpugan.loop.stack", "tpugan.loop.read", "tpugan.step",
            "tpugan.step.g", "tpugan.step.d"} <= names
    assert "tpugan.input.to_device" not in names  # the loader's thread
    assert t.counts["input.handoffs"] == 8 >= t.counts["input.starved"]
    assert sum(t.split.innermost.values()) == pytest.approx(t.window_us - t.busy_us())


def test_a_traced_run_on_the_cpu_reports_the_six_through_the_live_program(bench_root, monkeypatch):
    """``run.main`` with ``--trace 1``: the readers find the program through
    ``spans.of`` and ``live_program`` and every one of the six is in the
    result line, beside the harness's own laps."""
    # A traced run's first step learns the convolution kernels' names and
    # synchronizes CUDA, which the CPU build does not have.
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    sizes = {"cfg": {"img_size": 16, "batch_size": 8},
             "traffic": {"steps_per_dispatch": 3, "max_batches": 5, "profile_calls": 3}}
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", "dcgan-64.graphed", "--seed", "3000000019",
                           "--seconds", "0.3", "--trace", "1"],
                          device="cpu", look_for_chip=False, root=bench_root, sizes=sizes)
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(READERS) | {"input_wait_ms", "host_ms_per_step"} <= set(result["metrics"])
    assert 0.0 <= result["metrics"]["loader_starved_share"]["value"] <= 100.0
