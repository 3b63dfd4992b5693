"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Set-up builds the port's training step from
``--seed`` and drives its first calls, which the check follows; the window
then runs the step for ``--seconds`` on the host clock and ends in a
synchronize. ``--trace 1`` adds a profiled stretch after the window and
reports the per-layer metrics instead of the end-to-end ones. After the
window, with the program's state freed, the plain reference follows the
checked calls and decides ``correct``. The last line of standard output is
the result, one JSON object; the numbers compared, each with its limit, are
the last lines of standard error and the result's last key.

Exits 2 without a result where CUDA or the cell's cards are missing, and 3
where the process holds JAX or the JAX package after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

# Build and kernel caches at fixed paths inside the checkout.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_compute_cache")):
    os.environ[_var] = os.path.join(os.getcwd(), "build", "portbench", _sub)

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpugan")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, device=None, look_for_chip: bool = True, root: str = ".",
         sizes: Optional[dict] = None) -> int:
    """Run the cell; return the exit code. ``look_for_chip`` False with a
    ``device`` (the tests' CPU) skips the look for cards; ``sizes`` (the
    tests') replaces entries of the configuration and the workload file."""
    args = parse(argv)
    cell = harness.load_cell(args.workload, root)
    for part, new in (sizes or {}).items():
        getattr(cell, part).update(new)
    if look_for_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"{cell.name} needs {cell.chips} CUDA device(s), found {have}: no result")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else device.type

    mod = cell.program_module()
    t_ready = time.perf_counter()
    program = mod.Program(cell.cfg, cell.traffic, args.seed, device, learn_conv=bool(args.trace))
    t_built = time.perf_counter()
    record = program.setup()
    harness.sync(program)
    setup_s = time.perf_counter() - T0
    log(f"set-up: start to the cell's files {t_ready - T0:.3f} s, the program built "
        f"{t_built - t_ready:.3f} s ({program.phases}), its checked calls "
        f"{T0 + setup_s - t_built:.3f} s")
    window = harness.measure(program, args.seconds)
    steps = window.total_steps
    images_per_s = steps * program.images_per_step / window.seconds
    log(f"{cell.name} seed {args.seed}: set-up {setup_s:.3f} s; {window.calls} calls, {steps} "
        f"steps in {window.seconds:.3f} s: {images_per_s:.3f} images/s")
    tr = None
    if args.trace:
        tr, steady, tries = harness.profiled(program, cell.traffic["profile_calls"])
        log(f"profiled stretches (kernels, device ms, s): {tries}; "
            + ("two agree" if steady else "none agree: the most complete stands"))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        log(f"card: {harness.card_line(device)}; memory peak {peak} bytes")
    failed = window.failed_steps()
    run = harness.Run(cell, kind, window, tr, program.conv_names)
    if args.trace:
        metrics = harness.read_metrics(run, cell.metrics("per_layer"))
    else:
        # Each end-to-end metric by its quantity, the name before a dot, so
        # that a metric split by cells (``<quantity>.<cells>``) reads it too.
        e2e = {"train_images_per_s": images_per_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    result = {"correct": False, "attempted": steps, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type, "kind": kind, "count": 1,
                         "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_us() / 1e6, window_s=tr.window_us / 1e6)
        result["breakdown"] = harness.breakdown(run)

    # The check, with the program's state freed.
    program.release()
    del program, run, window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = mod.follow(record, cell.cfg, args.seed, device, cell.traffic["dtype"])
    numbers = check.compare(record, ref)
    limits = cell.traffic["limits"]
    result["correct"] = check.verdict(numbers, limits) and failed == 0
    log(f"reference followed {sum(len(l.losses[next(iter(l.losses))]) for l in ref.legs)} steps "
        f"in {time.perf_counter() - t0:.3f} s; leaves left out of the change: "
        f"{check.still_leaves(ref)}")

    found = forbidden_modules()
    if found:
        log(f"the process holds {found} after the window: no result")
        return 3
    # A NaN reading is written as null, so that the line stays JSON.
    compared = {k: {"value": numbers[k] if numbers[k] == numbers[k] else None, "limit": v}
                for k, v in limits.items()}
    compared["failed_steps"] = {"value": failed, "limit": 0}
    result["compared"] = compared
    print(json.dumps(result), flush=True)
    for k, v in compared.items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    return 0


if __name__ == "__main__":
    # One thread for torch's host ops: the run's host work is the launch
    # loop and the loader's thread, and idle pool threads only compete.
    torch.set_num_threads(1)
    sys.exit(main())
