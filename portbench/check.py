"""The comparison that decides ``correct``.

A run records the training steps its set-up drove through the window's own
call and feed (a ``Record`` of ``Leg``s); the plain reference follows the
same steps on the same inputs; three numbers compare the two, each against
a limit kept in the cell's workload file:

- ``loss_gap``: over every step of every leg and every loss the step
  returns, the largest ``|program - reference| / |reference|``;
- ``grad_gap``: the first step's gradient as the optimizer got it (Adam's
  first moment after one step over ``1 - b1``), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over each leg, the same way, over
  every leaf but those whose reference gradient is under a thousandth of
  the median leaf's: those move under Adam by round-off alone.

Where the state holds more than parameters (CycleGAN's replay buffers),
``held_gap`` compares it slot by slot at each leg's end: the largest
``|program - reference| / reference`` of a slot's norm.

A steadier number stands beside them: ``first_loss_gap``, the loss gap of
each leg's first step alone, before an update of the leg has let round-off
flip the sign of an element's Adam step (a gradient within rounding of 0
moves its element by +-lr either way). A cell's limits
(``workloads/<cell>.json``) name the numbers it compares.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Optional

import torch

NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "change_gap", "held_gap")
# A leaf whose reference gradient lies under this share of the median
# leaf's is left out of the change.
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Leg:
    """Steps of one call or more, from one start."""

    inputs: list  # the batches the steps took, CPU tensors, one tuple a call
    losses: dict  # loss name -> one float a step
    change: dict  # leaf -> norm of its change over the leg
    grad: Optional[dict] = None  # leaf -> norm of the first step's gradient (first leg)
    start: Optional[dict] = None  # the state the leg started from (legs after the first)
    held: Optional[dict] = None  # slot -> norm of what the state holds besides parameters


@dataclasses.dataclass
class Record:
    legs: list


def leaves(modules: dict) -> dict:
    return {f"{m}.{n}": p for m, mod in modules.items() for n, p in mod.named_parameters()}


def norms(tensors: dict) -> dict:
    """Each tensor's norm, in float64."""
    return {k: float(torch.linalg.vector_norm(t.detach().double())) for k, t in tensors.items()}


def clone(tensors: dict) -> dict:
    return {k: t.detach().clone() for k, t in tensors.items()}


def change_norms(now: dict, before: dict) -> dict:
    return norms({k: now[k].detach() - before[k] for k in before})


def first_grad_norms(optimizers: dict, modules: dict, b1: float) -> dict:
    """After one Adam step from zero moments, ``exp_avg = (1 - b1) * g``:
    the norm of each leaf's gradient as the optimizer got it; NaN for a
    leaf the optimizers hold no moment of."""
    state = {}
    for opt in optimizers.values():
        for p, s in opt.state.items():
            state[p] = s["exp_avg"]
    return {k: float(torch.linalg.vector_norm(state[p].detach().double())) / (1.0 - b1)
            if p in state else math.nan for k, p in leaves(modules).items()}


def snapshot(modules: dict, optimizers: dict) -> dict:
    """CPU copies of the modules' and optimizers' state."""
    cpu = lambda v: v.detach().cpu().clone() if torch.is_tensor(v) else v

    def opt_cpu(sd):
        return {"state": {i: {k: cpu(v) for k, v in s.items()} for i, s in sd["state"].items()},
                "param_groups": sd["param_groups"]}

    return {"modules": {k: {n: cpu(t) for n, t in m.state_dict().items()}
                        for k, m in modules.items()},
            "optimizers": {k: opt_cpu(o.state_dict()) for k, o in optimizers.items()}}


def restore(start: dict, modules: dict, optimizers: dict) -> None:
    """Load a snapshot's modules and the optimizers' moments and steps; each
    optimizer keeps its own settings."""
    for k, m in modules.items():
        m.load_state_dict(start["modules"][k])
    for k, o in optimizers.items():
        own = o.state_dict()
        own["state"] = start["optimizers"][k]["state"]
        o.load_state_dict(own)


def _worst(gaps) -> float:
    """The largest gap; NaN if any is NaN or there is none."""
    gaps = list(gaps)
    return math.nan if not gaps or any(g != g for g in gaps) else max(gaps)


def _leaf_gaps(prog: dict, ref: dict, keys: list) -> tuple:
    """Each leaf's gap, the program's norm against the reference's over the
    larger of the reference's norm of that leaf and of the median leaf;
    and that median."""
    median = statistics.median(ref[k] for k in keys) if keys else math.nan
    return {k: abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}, median


def moved_leaves(ref: "Record") -> list:
    """The leaves whose change is compared: those whose reference gradient
    is at least ``STILL_LEAF`` of the median leaf's."""
    g = ref.legs[0].grad
    median = statistics.median(g.values())
    return [k for k, v in g.items() if v >= STILL_LEAF * median]


def _loss_gaps(prog: Record, ref: Record, first: bool):
    for lp, lr in zip(prog.legs, ref.legs, strict=True):
        for name, rs in lr.losses.items():
            ps = lp.losses.get(name, [math.nan] * len(rs))
            for p, r in list(zip(ps, rs, strict=True))[:1 if first else None]:
                yield abs(p - r) / max(abs(r), 1e-30)


def compare(prog: Record, ref: Record) -> dict:
    """Every number of ``prog`` against ``ref`` (``NUMBERS``)."""
    g_ref = ref.legs[0].grad
    moved = moved_leaves(ref)
    grad, _ = _leaf_gaps(prog.legs[0].grad, g_ref, list(g_ref))
    legs = list(zip(prog.legs, ref.legs))
    out = {"loss_gap": _worst(_loss_gaps(prog, ref, first=False)),
           "first_loss_gap": _worst(_loss_gaps(prog, ref, first=True)),
           "grad_gap": _worst(grad.values()),
           "change_gap": _worst(_worst(_leaf_gaps(lp.change, lr.change, moved)[0].values())
                                for lp, lr in legs)}
    if any(lr.held for _, lr in legs):
        out["held_gap"] = _worst(abs((lp.held or {}).get(k, math.nan) - v) / max(v, 1e-30)
                                 for lp, lr in legs for k, v in (lr.held or {}).items())
    return out


def worst_leaves(prog: Record, ref: Record) -> dict:
    """For the record of a reading: the leaf behind the grad and the last
    leg's change gap, with the reference's norm of it over the median
    leaf's."""
    g = ref.legs[0].grad
    out = {}
    for name, p, r, keys in (("grad", prog.legs[0].grad, g, list(g)),
                             ("change", prog.legs[-1].change, ref.legs[-1].change,
                              moved_leaves(ref))):
        gaps, median = _leaf_gaps(p, r, keys)
        k = max(gaps, key=gaps.get)
        out[name] = [k, r[k] / median]
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits name within its limit; a NaN is not."""
    return all(numbers[k] <= limit for k, limit in limits.items())


def still_leaves(ref: Record) -> list:
    """The leaves left out of the change, for the record."""
    return sorted(set(ref.legs[0].grad) - set(moved_leaves(ref)))
