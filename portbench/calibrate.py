"""The readings a cell's limits are set from, at the cell's own sizes.

    python3 -m portbench.calibrate --workload NAME --seeds 12 --controls 3 --faults 3 --first-seed S

from the root of a checkout, on the card. For each of ``--seeds`` seeds it
drives the set-up's checked calls of the port and has the reference follow
them (the sound readings, whose largest is a limit's lower reading). For
each of ``--controls`` seeds the reference in the precision below the
cell's (float32 -> TF32, bf16 -> fp8; ``reference/precision.py``) stands in
the program's place on the same inputs, and the reference follows it (the
control, whose smallest reading is the upper one). For each of
``--faults`` seeds it plants each fault the cell can have in the port's
step and reads it the same way, where the cell can have it (``FAULTS``):
``half_batch`` (the step sees the first half of each batch) and
``no_swap`` (full replay buffers never swap). A state left unchanged
reads 1 on ``change_gap`` by construction and is not run. One JSON line a
reading on standard output, then a summary line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys

import torch

from portbench import check, harness


def half_batch(program) -> bool:
    """The fault: every batch cut to its first half before the step; for
    a batch of 2 or more."""
    step = program.probe.step
    if program.images_per_step < 2:
        return False

    def broken(state, *batch):
        return step(state, *(b[: b.shape[0] // 2] for b in batch))

    program.probe.step = broken
    return True


def no_swap(program) -> bool:
    """The fault: full replay buffers hand back the new fakes and keep
    what they hold; for a state with replay buffers."""
    buffers = getattr(program.state, "buffers", None)
    if not buffers:
        return False
    for buf in buffers.values():
        buf.push_and_pop = lambda batch, *a, **k: batch.detach().to(torch.float32)
    return True


# Each plants its fault in a built program, or says it cannot.
FAULTS = {"half_batch": half_batch, "no_swap": no_swap}


def reading(cell, mod, seed: int, device, kind: str, fault=None) -> dict:
    program = mod.Program(cell.cfg, cell.traffic, seed, device)
    if fault is not None and not FAULTS[fault](program):
        program.release()
        return None
    record = program.setup()
    program.release()
    del program
    torch.cuda.empty_cache()
    dtype = cell.traffic["dtype"]
    if kind == "control":
        # A configuration whose later legs start from the program's state
        # has the control go on from its own.
        takes = "from_record" in inspect.signature(mod.follow).parameters
        own = {"from_record": False} if takes else {}
        record = mod.follow(record, cell.cfg, seed, device, harness.CONTROL[dtype], **own)
    ref = mod.follow(record, cell.cfg, seed, device, dtype)
    return {"kind": kind if fault is None else fault, "seed": seed,
            **check.compare(record, ref), "worst": check.worst_leaves(record, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    mod = cell.program_module()
    device = torch.device("cuda", 0)
    rows = []
    seeds = [args.first_seed + 7919 * i for i in range(max(args.seeds, args.controls, args.faults))]
    plan = [("sound", None, s) for s in seeds[:args.seeds]]
    plan += [("control", None, s) for s in seeds[:args.controls]]
    plan += [("fault", f, s) for f in FAULTS for s in seeds[:args.faults]]
    cannot = set()  # faults the cell cannot have
    for kind, fault, seed in plan:
        row = None if fault in cannot else reading(cell, mod, seed, device, kind, fault)
        if row is None:
            cannot.add(fault)
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        for k in check.NUMBERS:  # "worst" is for the record only
            if k not in row:
                continue
            lo, hi = summary.setdefault(row["kind"], {}).get(k, (float("inf"), float("-inf")))
            summary[row["kind"]][k] = (min(lo, row[k]), max(hi, row[k]))
    print(json.dumps({"workload": cell.name, "card": harness.card_line(device),
                      "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
