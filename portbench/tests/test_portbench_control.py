"""The control and the faults on the card, at each cell's own size, one
seed each: a sound run passes the cell's limits, the reference in the
precision below the cell's (TF32 for fp32, fp8 for bf16) fails them, and
so does the port on half of each batch where the batch can be halved, and
the port whose full replay buffers never swap where it has them.
``portbench.calibrate`` takes the same readings over many seeds.

    python -m pytest -m gpu portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import calibrate, check, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 3_300_000_001


def cells() -> list:
    """The benchmark's cells and the parked ones (``portbench/parked.json``)."""
    names = []
    for path in ("BENCHMARK.json", os.path.join("portbench", "parked.json")):
        with open(os.path.join(ROOT, path)) as f:
            names += [w["name"] for w in json.load(f)["workloads"]]
    return names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's lower precision exists only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_sound_passes_and_control_fails(card, name, bench_root):
    cell = harness.load_cell(name, bench_root)
    mod = cell.program_module()
    limits = cell.traffic["limits"]
    sound = calibrate.reading(cell, mod, SEED, card, "sound")
    assert check.verdict(sound, limits), sound
    control = calibrate.reading(cell, mod, SEED, card, "control")
    assert not check.verdict(control, limits), control


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c for c in cells() if not c.startswith("cyclegan")])
def test_half_batch_fails(card, name, bench_root):
    cell = harness.load_cell(name, bench_root)
    faulty = calibrate.reading(cell, cell.program_module(), SEED, card, "fault", "half_batch")
    assert not check.verdict(faulty, cell.traffic["limits"]), faulty


def swapping_seed(seed: int, steps: int) -> int:
    """The first seed from ``seed`` whose buffer coins swap in the checked
    steps (batch 1, buffers full): on the others, 1 in 64 at three steps,
    buffers that never swap change nothing there."""
    from portbench.reference.cyclegan_256 import ReplayBuffer

    while True:
        draws = torch.Generator().manual_seed(seed)
        bufs = [ReplayBuffer(50, draws), ReplayBuffer(50, draws)]
        for b in bufs:
            b.push_and_pop(torch.zeros(50, 1))
        if any(float(b.push_and_pop(torch.ones(1, 1))) != 1.0
               for _ in range(steps) for b in bufs):
            return seed
        seed += 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c for c in cells() if c.startswith("cyclegan")])
def test_no_swap_fails(card, name, bench_root):
    cell = harness.load_cell(name, bench_root)
    seed = swapping_seed(SEED, cell.traffic["check_steps"])
    faulty = calibrate.reading(cell, cell.program_module(), seed, card, "fault", "no_swap")
    assert not check.verdict(faulty, cell.traffic["limits"]), faulty
