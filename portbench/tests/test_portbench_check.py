"""The check on the CPU at small sizes: the port and the plain reference
agree where nothing differs but rounding; a run whose timed path is broken
underneath comes out not correct; the comparison's arithmetic."""

from __future__ import annotations

import contextlib
import io
import json
import math

import pytest
import torch

from portbench import check, run
from portbench.check import Leg, Record

SMALL = {
    "dcgan-64.graphed": {"cfg": {"img_size": 16, "batch_size": 8},
                         "traffic": {"steps_per_dispatch": 3, "max_batches": 5}},
    "cyclegan-256.fp32": {"cfg": {"img_height": 32, "img_width": 32, "n_residual_blocks": 1},
                          "traffic": {"check_steps": 2}},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_run(cell: str, root: str, seed: int = 2_200_000_017) -> dict:
    """One run of ``cell`` of ``root/BENCHMARK.json`` on the CPU at its
    small size, past the look for a chip; its result line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"],
                      device="cpu", look_for_chip=False, root=root, sizes=SMALL[cell])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_port_and_reference_agree_on_the_first_step(cell, bench_root):
    result = cpu_run(cell, bench_root)
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device", "compared"}
    assert list(result)[-1] == "compared" and result["failed"] == 0
    assert result["attempted"] > 0
    from portbench import harness

    c = harness.load_cell(cell, bench_root)
    assert set(result["metrics"]) == {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    program = c.program_module()
    p = program.Program({**c.cfg, **SMALL[cell]["cfg"]}, {**c.traffic, **SMALL[cell]["traffic"]},
                        5, "cpu")
    record = p.setup()
    p.release()
    ref = program.follow(record, {**c.cfg, **SMALL[cell]["cfg"]}, 5, "cpu", "float32")
    numbers = check.compare(record, ref)
    # The first step of each leg sees the same weights on both sides: the
    # losses and the first gradients agree to float32 rounding.
    assert numbers["first_loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-3, numbers


def frozen(create_state):
    """A port whose optimizer steps do nothing: the state is unchanged."""

    def broken(*args, **kwargs):
        state = create_state(*args, **kwargs)
        for opt in state.optimizers.values():
            opt.step = lambda *a, **k: None
        return state

    return broken


def half_batch(make_step):
    def broken(*args, **kwargs):
        step = make_step(*args, **kwargs)
        return lambda state, imgs, *rest: step(state, imgs[: imgs.shape[0] // 2], *rest)

    return broken


def test_a_frozen_dcgan_is_not_correct(monkeypatch, bench_root):
    from tpugan_torch.models import dcgan

    monkeypatch.setattr(dcgan, "create_state", frozen(dcgan.create_state))
    result = cpu_run("dcgan-64.graphed", bench_root)
    assert result["correct"] is False
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_dcgan_on_half_its_batch_is_not_correct(monkeypatch, bench_root):
    from tpugan_torch.models import dcgan

    monkeypatch.setattr(dcgan, "make_step", half_batch(dcgan.make_step))
    result = cpu_run("dcgan-64.graphed", bench_root)
    assert result["correct"] is False


def test_a_frozen_cyclegan_is_not_correct(monkeypatch, bench_root):
    from tpugan_torch.models import cyclegan

    monkeypatch.setattr(cyclegan, "create_state", frozen(cyclegan.create_state))
    result = cpu_run("cyclegan-256.fp32", bench_root)
    assert result["correct"] is False


def test_a_cyclegan_whose_full_buffers_never_swap_is_not_correct(monkeypatch, bench_root):
    """Full replay buffers that hand back the new fakes and keep the fill."""
    from tpugan_torch.train import replay

    push_and_pop = replay.ReplayBuffer.push_and_pop

    def never_swaps(self, batch, *args, **kwargs):
        if self.count < self.max_size:
            return push_and_pop(self, batch, *args, **kwargs)
        return batch.detach().to(torch.float32)

    monkeypatch.setattr(replay.ReplayBuffer, "push_and_pop", never_swaps)
    result = cpu_run("cyclegan-256.fp32", bench_root)
    assert result["correct"] is False
    assert result["compared"]["held_gap"]["value"] > 0.01


def test_an_altered_loss_is_not_correct(monkeypatch, bench_root):
    """A step whose reported loss is altered where it is produced."""
    from tpugan_torch.models import cyclegan

    make_step = cyclegan.make_step

    def altered(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def broken(state, a, b):
            state, out = step(state, a, b)
            return state, {**out, "g_loss": out["g_loss"] * 1.1}

        return broken

    monkeypatch.setattr(cyclegan, "make_step", altered)
    assert cpu_run("cyclegan-256.fp32", bench_root)["correct"] is False


def leg(losses, change, grad=None):
    return Leg([], {"loss": losses}, change, grad)


def test_compare_takes_the_worst_leaf_against_the_median():
    grad = {"a": 1.0, "b": 2.0, "c": 3.0, "still": 1e-6}
    ref = Record([leg([1.0, 2.0], {"a": 1.0, "b": 2.0, "c": 3.0, "still": 0.5}, grad)])
    prog = Record([leg([1.0, 2.2], {"a": 1.1, "b": 2.0, "c": 3.0, "still": 5.0},
                       {**grad, "c": 3.3})])
    n = check.compare(prog, ref)
    assert n["loss_gap"] == pytest.approx(0.1) and n["first_loss_gap"] == 0.0
    # Leaf a: 0.1 against the median leaf's 2.0; the still leaf is left out.
    assert n["change_gap"] == pytest.approx(0.05)
    assert n["grad_gap"] == pytest.approx(0.1)
    assert check.still_leaves(ref) == ["still"]


def test_compare_sticks_at_nan():
    ref = Record([leg([1.0, 1.0], {"a": 1.0}, {"a": 1.0})])
    prog = Record([leg([math.nan, 1.0], {"a": math.nan}, {"a": 1.0})])
    n = check.compare(prog, ref)
    assert math.isnan(n["loss_gap"]) and math.isnan(n["change_gap"])
    assert not check.verdict(n, {"loss_gap": 1.0})
