#!/usr/bin/env python3
"""Times of the port's closed-form GP kernels under other launch plans.

    python3 scripts/sweep_gp_plan.py

Run from the root of a checkout on a machine with a CUDA card. At the
WGAN-GP slice shape (64, 784, 512, 256), and in both directions, the plan
rule of ``tpugan_torch.ops.mlp_gp.plan`` is rerun with other constants (the
CTAs below which a product takes narrower tiles, the least depth stages a
rank keeps), with
programmatic dependent launch on and off. Each plan is held to the plain
version, then timed three ways: ``graph`` (calls captured in one CUDA graph
and replayed: device time with the gaps between launches, without the
host), ``device`` (torch.profiler's kernel durations, which overlap under
programmatic dependent launch) and ``events`` (CUDA events around eager
calls, host included). The shipped constants are marked ``*``. Prints one
line a plan and the card's name and power limit.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

REPS = 50
CTAS_MIN = (100, 256)
STAGES_MIN = (1, 2, 4)


def main() -> int:
    import torch

    from tpugan_torch.ops import mlp_gp as gp

    if not torch.cuda.is_available():
        raise SystemExit("sweep_gp_plan: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    ins = chip_smoke._gp_inputs(chip_smoke.GP_SHAPE, 1.0, False, gen)
    want_f = gp.mlp_gp_fwd_ref(*ins)
    g, m1, m2, u, t = want_f
    res = (gp.q_from(g, gp.norm_penalty(g)[1], 1.0).contiguous(), m1, m2, ins[1], ins[3], u, t)
    want_b = gp.mlp_gp_bwd_ref(*res)
    shipped = (gp.CTAS_MIN, gp.STAGES_MIN, gp.PDL)
    fns = {"fwd": (lambda: gp.mlp_gp_fwd(*ins), want_f),
           "bwd": (lambda: gp.mlp_gp_bwd(*res), want_b)}
    try:
        for ctas, stages, pdl in itertools.product(CTAS_MIN, STAGES_MIN, (True, False)):
            gp.CTAS_MIN, gp.STAGES_MIN, gp.PDL = ctas, stages, pdl
            gp.plan.cache_clear()
            gp._plan_arg.cache_clear()
            for k, (fn, want) in fns.items():
                mark = "*" if (ctas, stages, pdl) == shipped else " "
                err = max(chip_smoke._rel_err(a, b) for a, b in zip(fn(), want))
                p = gp.plan(*chip_smoke.GP_SHAPE, k, pdl)
                print(f"[sweep] {k} ctas_min {ctas:3d} stages_min {stages} pdl {int(pdl)}{mark} "
                      f"CTAs {p.grid} bn {p.bn} ks {tuple(q.ks for q in p.products)}: "
                      f"graph {chip_smoke.graph_ms(fn):.4f} ms, device "
                      f"{chip_smoke.fmt_ms(chip_smoke.device_ms(fn, REPS), 0)}, events "
                      f"{chip_smoke.cuda_ms(fn, REPS):.4f}, rel err {err:.2e}", flush=True)
    finally:
        gp.CTAS_MIN, gp.STAGES_MIN, gp.PDL = shipped
        gp.plan.cache_clear()
        gp._plan_arg.cache_clear()
    print(f"[sweep] on {torch.cuda.get_device_name(0)} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
