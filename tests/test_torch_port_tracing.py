"""The port's tracing (``tpugan_torch/utils/tracing.py``) on the CPU: spans
off by default run no ``record_function`` on the loader, step, dispatch
and replay-buffer paths and leave no range in a profile;
on, one DCGAN step (``_template_b.make_step_b``) fed by the threaded
``DeviceLoader`` records the step, its G and D phases inside it and the
loader's hand-off and copy on their threads; ``graph_steps``' CPU path
records its K steps and no replay; the counters."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from tpugan_torch.data.loader import DeviceLoader
from tpugan_torch.models import dcgan
from tpugan_torch.train.loop import _stack_batches, graph_steps, host_rows
from tpugan_torch.train.replay import ReplayBuffer
from tpugan_torch.utils import tracing

CPU = torch.device("cpu")
B, SIZE = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dcgan_step():
    cfg = dcgan.Config(img_size=SIZE, batch_size=B, latent_dim=8, synthetic_data=True)
    state = dcgan.create_state(cfg, dcgan.build(cfg, CPU), CPU)
    return state, dcgan.make_step(cfg, state)


def _images(n: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)


def _all_threads_profile():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _port_ranges(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("tpugan.")]


def test_spans_off_run_no_record_function_and_leave_no_range(dcgan_step, monkeypatch):
    """The loader, a dispatch's stacking, steps and read-back, and a replay
    buffer's swap."""
    state, step = dcgan_step
    assert tracing.span("tpugan.step", 3) is tracing.span("tpugan.loop.stack")  # one no-op
    made = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: made.append(a) or record_function(*a))
    fused = graph_steps(step, 2)
    with _all_threads_profile() as prof:
        batches = list(DeviceLoader([_images(2 * B)], B, CPU).epoch(0))
        state, out = fused(state, *_stack_batches(batches))
        host_rows(out, fused.heavy_keys, 2)
        ReplayBuffer(2, (1,), CPU, torch.Generator()).push_and_pop(torch.zeros(3, 1))
    assert made == [] and _port_ranges(prof) == []


def test_spans_on_record_the_step_its_phases_and_the_loader(dcgan_step):
    state, step = dcgan_step
    loader = DeviceLoader([_images(2 * B)], B, CPU)
    tracing.reset()
    with tracing.enabled(), _all_threads_profile() as prof:
        for batch in loader.epoch(0):
            state, _ = step(state, *batch)
    assert tracing.span("tpugan.step") is tracing.span("tpugan.step.g")  # off again after
    ranges = _port_ranges(prof)
    by = {n: [e for e in ranges if e.name == n] for n in {e.name for e in ranges}}
    assert len(by["tpugan.step"]) == 2
    for phase in ("tpugan.step.g", "tpugan.step.d"):
        assert [e.cpu_parent.name for e in by[phase]] == ["tpugan.step"] * 2
    main = {e.thread for e in by["tpugan.step"]}
    assert {e.thread for e in by["tpugan.input.wait"]} == main
    assert len(by["tpugan.input.to_device"]) == 2
    assert not {e.thread for e in by["tpugan.input.to_device"]} & main
    assert tracing.counts["input.handoffs"] == 2
    assert 0 <= tracing.counts["input.starved"] <= tracing.counts["input.handoffs"]


def test_graph_steps_on_the_cpu_record_k_steps_and_no_replay(dcgan_step):
    state, step = dcgan_step
    k = 2
    fused = graph_steps(step, k)
    tracing.reset()
    with tracing.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = fused(state, torch.from_numpy(_images(k * B).reshape(k, B, SIZE, SIZE, 1)))
    names = [e.name for e in _port_ranges(prof)]
    assert names.count("tpugan.step") == k
    assert not [n for n in names if n.startswith("tpugan.graph.")]
    assert tracing.counts["graph.replays"] == 0 and fused.replays == 0


def test_counters_add_read_zero_unset_and_reset():
    tracing.reset()
    tracing.count("in.fwd")
    tracing.count("in.fwd.captured", 0)
    tracing.count("in.fwd", 2)
    assert (tracing.counts["in.fwd"], tracing.counts["in.fwd.captured"]) == (3, 0)
    assert tracing.counts["gp.bwd"] == 0
    tracing.reset()
    assert tracing.counts["in.fwd"] == 0
    with tracing.enabled():
        with tracing.enabled():
            pass
        assert tracing.span("tpugan.step") is not tracing.span("tpugan.step")
    assert tracing.span("tpugan.step") is tracing.span("tpugan.step")
