#!/usr/bin/env python3
"""Device time of the port's instance-norm kernels under other launch plans.

    python3 scripts/sweep_in_plan.py

Run from the root of a checkout on a machine with a CUDA card. At each shape
below and in both directions, every regime-B plan the kernels can run
(cluster size c of 1 to 8 with a slice of at most 64 KB, 128 to 512 threads)
is launched in place of ``instance_norm.plan``'s, held to the plain version,
and timed: device time per call from torch.profiler over 50 calls, and CUDA
events over the same calls. The plan that ``plan`` picks is marked ``*``.
Prints one line a plan and the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SHAPES = [(2, 64, 256, 256), (1, 64, 256, 256), (5, 64, 256, 256), (2, 128, 128, 128),
          (1, 64, 128, 128)]
REPS = 50


def main() -> int:
    import torch

    from tpugan_torch.ops import instance_norm as tin

    if not torch.cuda.is_available():
        raise SystemExit("sweep_in_plan: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps, slope = 1e-5, 0.2
    chosen_arg = tin._plan_arg
    for shape in SHAPES:
        n, c, h, w = shape
        planes, hw = n * c, h * w
        x = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        y_r, mean, rstd = tin.in_act_fwd_ref(x, eps, slope)
        dx_r = tin.in_act_bwd_ref(g, x, mean, rstd, slope)
        for direction, per in (("fwd", 4), ("bwd", 8)):
            chosen = tin.plan(planes, hw, direction)
            bound = chip_smoke.bound_ms(0.0, (8 if direction == "fwd" else 12) * x.numel())[0]
            for cl in (1, 2, 4, 8):
                size = (-(-hw // cl) + 3) // 4 * 4
                if size * per > tin.SLICE_BYTES_MAX or size * (cl - 1) >= hw:
                    continue
                for threads in (128, 256, 512):
                    p = tin.Plan("B", cl, size, size, threads, planes * cl, size * per)
                    arg = (p, tin._c_plan(p, planes, hw))
                    tin._plan_arg = lambda *a, arg=arg: arg
                    try:
                        if direction == "fwd":
                            def fn():
                                return tin.in_act_fwd(x, eps, slope)
                            err = float((fn()[0] - y_r).abs().max())
                        else:
                            def fn():
                                return tin.in_act_bwd(g, x, mean, rstd, slope)
                            err = float((fn() - dx_r).abs().max())
                        dev = chip_smoke.device_ms(fn, REPS)
                        ev = chip_smoke.cuda_ms(fn, REPS)
                    finally:
                        tin._plan_arg = chosen_arg
                    mark = "*" if p == chosen else " "
                    print(f"[sweep] {str(shape):18s} {direction} c {cl} threads {threads:3d} "
                          f"slice {size * per // 1024:3d} KB{mark} device {dev:.4f} ms "
                          f"({bound / dev:.1%} of bound {bound:.4f}), events {ev:.4f}, "
                          f"max err {err:.2e}", flush=True)
    print(f"[sweep] on {torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
