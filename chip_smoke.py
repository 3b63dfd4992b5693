#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpugan_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card. Phases:

1. device: the card's name and power limit, the TF32 flags, whether the
   native host pipeline is built;
2. build: every CUDA kernel of the CycleGAN slice from ``tpugan_torch/csrc``;
3. kernel parity: each kernel against its plain PyTorch version on the card,
   forward and backward, at every shape the slice gives it and at slopes
   0.0, 0.2 and 1.0, plus a ragged H*W and a large-offset case; each
   kernel's time beside the plain version's (CUDA events);
4. slice: ``tpugan_torch.models.cyclegan.main`` at 256px, batch 1, 9 residual
   blocks, fp32, for 6 steps with samples and checkpoints; checks finite
   losses, the output files, and that every instance-norm site went through
   the kernels (launch counters); then the steady-state step time.

Any failure raises, and the script exits non-zero without the final line.
The last three lines are the kernels' JSON record, ``nvidia-smi``'s name and
power limit, and ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, kernel against the plain version, both fp32 on the card with
# sums in different orders. y: 1e-5 absolute on unit-scale planes; with an
# offset mu the inputs carry ulp(mu) of rounding, so 1e-5 * (1 + |mu|/std).
# dx: 1e-4 of the plane's largest |dx| (the backward subtracts two means).
Y_ATOL = 1e-5
DX_RTOL = 1e-4
SLOPES = (0.0, 0.2, 1.0)
EPS = 1e-5

# (B, C, H, W) of every instance-norm call of the slice at 256px, batch 1,
# and how often one training step makes it (the sampler's batch-5 shapes:
# per sample grid). G on [real_a; real_b] runs at batch 2, G on one fake at
# batch 1; the discriminators at batch 1 in the G phase, 2 in their own.
STEP_SHAPES = {
    (2, 64, 256, 256): 4, (2, 128, 128, 128): 4, (2, 256, 64, 64): 38,
    (1, 64, 256, 256): 4, (1, 128, 128, 128): 4, (1, 256, 64, 64): 38,
    (1, 128, 64, 64): 2, (1, 256, 32, 32): 2, (1, 512, 16, 16): 2,
    (2, 128, 64, 64): 2, (2, 256, 32, 32): 2, (2, 512, 16, 16): 2,
}
SAMPLE_SHAPES = {(5, 64, 256, 256): 4, (5, 128, 128, 128): 4, (5, 256, 64, 64): 38}
FWD_PER_STEP = sum(STEP_SHAPES.values())  # 104
BWD_PER_STEP = FWD_PER_STEP  # every application is differentiated
FWD_PER_SAMPLE = sum(SAMPLE_SHAPES.values())  # 46
N_STEPS, SAMPLE_INTERVAL = 6, 5


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "tpugan_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, REPO)
    from tpugan import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")
    log(f"[device] tf32 cudnn={torch.backends.cudnn.allow_tf32} "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} | native host pipeline: "
        f"{native.available()}")
    return smi


def phase_build():
    from tpugan_torch.ops import _build

    _build.library()
    info = _build.BuildInfo
    log(f"[build] {os.path.relpath(info.path, REPO)} compiled={info.compiled} "
        f"in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[build] " + line.strip())


def _parity_case(shape, slope, offset, gen):
    import torch

    from tpugan_torch.ops import instance_norm as tin

    x = torch.randn(shape, device="cuda", generator=gen) + offset
    g = torch.randn(shape, device="cuda", generator=gen)
    y_k, mean_k, rstd_k = tin.in_act_fwd(x, EPS, slope)
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, EPS, slope)
    dx_k = tin.in_act_bwd(g, x, mean_r, rstd_r, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean_r, rstd_r, slope)
    torch.cuda.synchronize()
    y_err = float((y_k - y_r).abs().max())
    stat_err = float(torch.maximum((mean_k - mean_r).abs().max(), (rstd_k - rstd_r).abs().max()))
    dx_err = float((dx_k - dx_r).abs().max())
    dx_scale = float(dx_r.abs().max())
    y_tol = Y_ATOL * (1.0 + abs(offset))
    ok = y_err <= y_tol and stat_err <= y_tol and dx_err <= DX_RTOL * dx_scale + 1e-7
    if not ok:
        raise AssertionError(
            f"kernel disagrees at {shape} slope {slope} offset {offset}: y {y_err:.3g} "
            f"(tol {y_tol:.3g}), stats {stat_err:.3g}, dx {dx_err:.3g} (tol "
            f"{DX_RTOL * dx_scale:.3g})"
        )
    return y_err, dx_err


def phase_parity():
    import torch

    from tpugan_torch.ops import instance_norm as tin

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"fwd": 0.0, "bwd": 0.0}
    cases = [(s, sl, 0.0) for s in {**STEP_SHAPES, **SAMPLE_SHAPES} for sl in SLOPES]
    cases += [((2, 8, 31, 31), sl, 0.0) for sl in SLOPES]  # ragged H*W: scalar path
    cases += [((2, 64, 64, 64), sl, 100.0) for sl in SLOPES]  # mean = 100 * std
    for shape, slope, offset in cases:
        y_err, dx_err = _parity_case(shape, slope, offset, gen)
        worst["fwd"] = max(worst["fwd"], y_err)
        worst["bwd"] = max(worst["bwd"], dx_err)
    log(f"[parity] {len(cases)} cases pass: max |dy| {worst['fwd']:.3g}, "
        f"max |ddx| {worst['bwd']:.3g} (y tol {Y_ATOL:g}*(1+|offset|), dx tol "
        f"{DX_RTOL:g} of max|dx|)")

    # Times at every shape of the step, kernel beside plain, CUDA events.
    per_step = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    log("[time] shape            launches/step  fwd ms  plain  bwd ms  plain")
    for shape, n in {**STEP_SHAPES, **SAMPLE_SHAPES}.items():
        x = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        _, mean, rstd = tin.in_act_fwd_ref(x, EPS, 0.0)
        reps = max(5, min(200, int(2e8 / x.numel())))
        t = [
            cuda_ms(lambda: tin.in_act_fwd(x, EPS, 0.0), reps),
            cuda_ms(lambda: tin.in_act_fwd_ref(x, EPS, 0.0), reps),
            cuda_ms(lambda: tin.in_act_bwd(g, x, mean, rstd, 0.0), reps),
            cuda_ms(lambda: tin.in_act_bwd_ref(g, x, mean, rstd, 0.0), reps),
        ]
        if shape in STEP_SHAPES:
            per_step["fwd"][0] += n * t[0]
            per_step["fwd"][1] += n * t[1]
            per_step["bwd"][0] += n * t[2]
            per_step["bwd"][1] += n * t[3]
        gbs = 2 * x.numel() * 4 / t[0] / 1e6  # read x once, write y once
        log(f"[time] {str(shape):18s} {n:3d}{' (sample)' if shape in SAMPLE_SHAPES else '         '}"
            f" {t[0]:7.4f} {t[1]:7.4f} {t[2]:7.4f} {t[3]:7.4f}  fwd {gbs:6.0f} GB/s min-traffic")
    log(f"[time] one step's 104 launches: fwd {per_step['fwd'][0]:.3f} ms (plain "
        f"{per_step['fwd'][1]:.3f}), bwd {per_step['bwd'][0]:.3f} ms (plain "
        f"{per_step['bwd'][1]:.3f})")
    return worst, per_step


def phase_slice(smi):
    import numpy as np
    import torch

    from tpugan_torch.models import cyclegan
    from tpugan_torch.ops import instance_norm as tin

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    metrics = os.path.join(out_dir, "metrics.jsonl")
    argv = [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(N_STEPS),
        "--sample_interval", str(SAMPLE_INTERVAL), "--checkpoint_interval", "1",
        "--output_dir", out_dir, "--metrics_jsonl", metrics,
    ]
    tin.reset_launch_counts()
    t0 = time.perf_counter()
    cyclegan.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": tin.fwd_launches, "bwd": tin.bwd_launches}
    log("")
    n_samples = len(range(0, N_STEPS, SAMPLE_INTERVAL))
    want = {
        "fwd": N_STEPS * FWD_PER_STEP + n_samples * FWD_PER_SAMPLE,
        "bwd": N_STEPS * BWD_PER_STEP,
    }
    log(f"[slice] main() took {wall:.1f} s (data, build of modules, {N_STEPS} steps, "
        f"{n_samples} samples); launches {launches}, expected {want}")
    log(f"[slice] tf32 as run() left it: cudnn={torch.backends.cudnn.allow_tf32} "
        f"matmul={torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 run with TF32 left on")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")

    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != N_STEPS:
        raise AssertionError(f"{len(rows)} metric rows, expected {N_STEPS}")
    for row in rows:
        bad = {k: v for k, v in row.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {row['step']}: {bad}")
    log(f"[slice] losses finite at all {N_STEPS} steps; last: {rows[-1]}")
    imgs = os.path.join(out_dir, "images", "monet2photo")
    ckpts = os.path.join(out_dir, "saved_models", "monet2photo")
    need = [os.path.join(imgs, f"{i}.png") for i in range(0, N_STEPS, SAMPLE_INTERVAL)]
    need += [os.path.join(ckpts, f"{m}_0.pth") for m in cyclegan.MODULES]
    missing = [p for p in need if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"missing outputs: {missing}")
    with open(need[0], "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{need[0]} is not a PNG")
    sd = torch.load(need[-1], map_location="cpu", weights_only=True)
    if not all(torch.isfinite(v).all() for v in sd.values()):
        raise AssertionError("non-finite weights in the D_B checkpoint")
    log(f"[slice] wrote {len(need)} files: samples {[os.path.basename(p) for p in need[:n_samples]]}"
        f", checkpoints {[os.path.basename(p) for p in need[n_samples:]]}")

    # Steady state: the same entry points, one fixed uint8 batch on the card.
    cfg = cyclegan.Config(synthetic_data=True, output_dir=out_dir)
    dev = torch.device("cuda")
    modules = cyclegan.build(cfg, dev)
    state = cyclegan.create_state(cfg, modules, dev)
    step = cyclegan.make_step(cfg, modules, dev)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)).to(dev)
            for _ in range(2))
    for _ in range(3):
        state, out = step(state, a, b)
    torch.cuda.synchronize()
    n_timed = 20
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, out = step(state, a, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    if not all(math.isfinite(float(v)) for v in out.values()):
        raise AssertionError(f"non-finite losses in the timed steps: {out}")
    log(f"[slice] steady state on {torch.cuda.get_device_name(0)} ({smi}): "
        f"{step_ms:.2f} ms/step, {1e3 / step_ms:.2f} images/s (256px, batch 1, 9 blocks, "
        f"fp32, TF32 off; mean of {n_timed} steps after 3 warm-up)")
    return launches


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()
    worst, per_step = phase_parity()
    launches = phase_slice(smi)
    src = "tpugan_torch/csrc/instance_norm.cu"
    record = {"kernels": [
        {"name": "in_act_fwd", "route": "cuda", "source": src,
         "replaces": "tpugan/ops/pallas_kernels.py:226", "launches": launches["fwd"],
         "max_abs_err": worst["fwd"], "ms": per_step["fwd"][0], "plain_ms": per_step["fwd"][1]},
        {"name": "in_act_bwd", "route": "cuda", "source": src,
         "replaces": "tpugan/ops/pallas_kernels.py:237", "launches": launches["bwd"],
         "max_abs_err": worst["bwd"], "ms": per_step["bwd"][0], "plain_ms": per_step["bwd"][1]},
    ]}
    log(json.dumps(record))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
