#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpugan_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card. Phases:

1. device: the card's name and power limit, the TF32 flags, whether the
   native host pipeline is built;
2. build: every CUDA kernel of the port from ``tpugan_torch/csrc`` (one nvcc
   per source, started together), with ptxas's registers and spills;
3. IN parity and time: the instance-norm pair against its plain PyTorch
   version on the card, forward and backward, at every shape the CycleGAN
   slice gives it and at slopes 0.0, 0.2 and 1.0, plus a ragged H*W and a
   large-offset case; at each step shape the kernels' times (CUDA events)
   beside the plain version's, the bound, and ``F.instance_norm``'s time;
4. CycleGAN slice: ``tpugan_torch.models.cyclegan.main`` at 256px, batch 1,
   9 residual blocks, fp32, for 6 steps with samples and checkpoints; checks
   finite losses, the output files, and that every instance-norm site went
   through the kernels (launch counters); then the steady-state step time;
5. GP parity and time: the closed-form WGAN-GP pair against its plain
   version on the card at five cases, then both timed at the slice shape
   beside the bound, and the generic double-backward penalty for scale;
6. WGAN-GP slice: ``tpugan_torch.models.wgan_gp.main`` at the reference
   configuration (batch 64, 28x28x1, latent 100, n_critic 5) for 50 batches;
   checks finite losses, the sample PNGs and exactly one GP forward and one
   backward launch per critic step; then the steady-state schedule unit.

The bounds use the published peaks of the card ``nvidia-smi`` names
(``PEAKS``): FP32 outside the tensor cores and HBM bandwidth.

Any failure raises, and the script exits non-zero without the final line.
The last three lines are the kernels' JSON record (every kernel with its
launches on the main path, error, times, bound and library-call time), ``nvidia-smi``'s name and
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

# Published peaks (NVIDIA data sheets, dense): FP32 outside the tensor cores
# in FLOP/s and HBM bandwidth in bytes/s. nvidia-smi names the SXM part
# "NVIDIA H100 80GB HBM3".
PEAKS = {
    "H100 SXM": (67e12, 3.35e12),
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
}

# The closed-form GP at the WGAN-GP slice: (B, N0, N1, N2), and the cases
# held against the plain version: (shape, x scale, all zero).
GP_SHAPE = (64, 784, 512, 256)
GP_CASES = [
    (GP_SHAPE, 1.0, False),
    ((1, 784, 512, 256), 1.0, False),
    ((7, 13, 100, 36), 1.0, False),
    (GP_SHAPE, 100.0, False),
    (GP_SHAPE, 1.0, True),  # dead zone: g = 0, P = 1, q = 0
]
# Tolerances, kernel against plain, fp32 with sums in different orders: g and
# t to 1e-5 of their largest |.|, P to 1e-5 relative, the weight gradients to
# 1e-4 of their largest |.|. A mask entry may differ only where its
# pre-activation is within 1e-5 of the largest |z| of 0.
GP_RTOL, GP_GRAD_RTOL, GP_FLIP_RTOL = 1e-5, 1e-4, 1e-5
WGAN_BATCHES, WGAN_SAMPLE_INTERVAL = 50, 10


def log(msg: str = "") -> None:
    print(msg, flush=True)


def peaks(name: str):
    """(FP32 FLOP/s, HBM bytes/s) of the card ``name``; the SXM figures for
    any H100 name without "PCIe" or "NVL"."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS["H100 " + key]
    return PEAKS["H100 SXM"]


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, "operations" or "bytes") on this card."""
    import torch

    peak_flops, peak_bw = peaks(torch.cuda.get_device_name(0))
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    from tpugan_torch import native

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
    peak_flops, peak_bw = peaks(torch.cuda.get_device_name(0))
    log(f"[device] peaks used for bounds: FP32 {peak_flops / 1e12:g} TFLOP/s, "
        f"HBM {peak_bw / 1e12:g} TB/s (PEAKS)")
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
    log(f"[in parity] {len(cases)} cases pass: max |dy| {worst['fwd']:.3g}, "
        f"max |ddx| {worst['bwd']:.3g} (y tol {Y_ATOL:g}*(1+|offset|), dx tol "
        f"{DX_RTOL:g} of max|dx|)")

    # Times at every shape of the step, kernel beside plain, CUDA events; the
    # bound (8 bytes an element forward, 12 backward) and F.instance_norm,
    # the one PyTorch call that computes the slope-1 forward.
    import torch.nn.functional as F

    per_step = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for k in ("fwd", "bwd")}
    per_step["fwd"]["library_ms"] = 0.0
    log("[in time] shape            launches/step  fwd ms  plain   bound  F.inst  "
        "bwd ms  plain   bound")
    for shape, n in {**STEP_SHAPES, **SAMPLE_SHAPES}.items():
        x = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        _, mean, rstd = tin.in_act_fwd_ref(x, EPS, 0.0)
        reps = max(5, min(200, int(2e8 / x.numel())))
        t = {
            "fwd": (cuda_ms(lambda: tin.in_act_fwd(x, EPS, 0.0), reps),
                    cuda_ms(lambda: tin.in_act_fwd_ref(x, EPS, 0.0), reps),
                    bound_ms(0.0, 8 * x.numel())[0]),
            "bwd": (cuda_ms(lambda: tin.in_act_bwd(g, x, mean, rstd, 0.0), reps),
                    cuda_ms(lambda: tin.in_act_bwd_ref(g, x, mean, rstd, 0.0), reps),
                    bound_ms(0.0, 12 * x.numel())[0]),
        }
        lib = cuda_ms(lambda: F.instance_norm(x, eps=EPS), reps)
        if shape in STEP_SHAPES:
            for k in ("fwd", "bwd"):
                for key, v in zip(("ms", "plain_ms", "bound_ms"), t[k]):
                    per_step[k][key] += n * v
            per_step["fwd"]["library_ms"] += n * lib
        log(f"[in time] {str(shape):18s} {n:3d}"
            f"{' (sample)' if shape in SAMPLE_SHAPES else '         '}"
            f" {t['fwd'][0]:7.4f} {t['fwd'][1]:7.4f} {t['fwd'][2]:7.4f} {lib:7.4f}"
            f" {t['bwd'][0]:7.4f} {t['bwd'][1]:7.4f} {t['bwd'][2]:7.4f}")
    f, b = per_step["fwd"], per_step["bwd"]
    log(f"[in time] one step's 104 launches: fwd {f['ms']:.3f} ms (plain {f['plain_ms']:.3f}, "
        f"bound {f['bound_ms']:.3f}, F.instance_norm {f['library_ms']:.3f}), bwd {b['ms']:.3f} "
        f"ms (plain {b['plain_ms']:.3f}, bound {b['bound_ms']:.3f}, library none)")
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


def _gp_inputs(shape, scale: float, zero: bool, gen):
    """x in [-scale, scale] and the critic's weights at torch's default init
    scale, U(+-1/sqrt(fan_in)), in nn.Linear's (out, in) layout."""
    import torch

    b, n0, n1, n2 = shape

    def u(*dims, bound):
        if zero:
            return torch.zeros(dims, device="cuda")
        return (torch.rand(dims, device="cuda", generator=gen) * 2 - 1) * bound

    x = u(b, n0, bound=scale)
    w1, b1 = u(n1, n0, bound=n0 ** -0.5), u(n1, bound=n0 ** -0.5)
    w2, b2 = u(n2, n1, bound=n1 ** -0.5), u(n2, bound=n1 ** -0.5)
    w3 = u(1, n2, bound=n2 ** -0.5)
    return x, w1, b1, w2, b2, w3


def _rel_err(got, want) -> float:
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


def _gp_case(shape, scale, zero, gen):
    """One case of the GP pair against its plain version; returns the largest
    absolute errors (forward g, backward weight gradients) and the number of
    mask entries that differ."""
    import torch

    from tpugan_torch.ops import mlp_gp as gp

    ins = _gp_inputs(shape, scale, zero, gen)
    x, w1, b1, w2, b2, w3 = ins
    g_k, m1_k, m2_k, u_k, t_k = gp.mlp_gp_fwd(*ins)
    g_r, m1_r, m2_r, u_r, t_r = gp.mlp_gp_fwd_ref(*ins)
    again = gp.mlp_gp_fwd(*ins)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, (g_k, m1_k, m2_k, u_k, t_k))):
        raise AssertionError(f"gp forward at {shape} does not repeat bit for bit")
    flips = int((m1_k != m1_r).sum()) + int((m2_k != m2_r).sum())
    if flips:
        # Masks differ only where a pre-activation sits within rounding of 0;
        # then hold the kernel to the plain version run with its masks.
        z1 = x @ w1.T + b1
        z2 = (z1 * m1_k) @ w2.T + b2
        for z, mk, mr in ((z1, m1_k, m1_r), (z2, m2_k, m2_r)):
            at = mk != mr
            if at.any() and float(z[at].abs().max()) >= GP_FLIP_RTOL * float(z.abs().max()):
                raise AssertionError(f"gp mask differs at {shape} away from z = 0: "
                                     f"|z| {float(z[at].abs().max()):.3g}")
        g_r, m1_r, m2_r, u_r, t_r = gp.mlp_gp_fwd_ref(*ins, masks=(m1_k, m2_k))
    p_k, n_k = gp.norm_penalty(g_k)
    p_r, n_r = gp.norm_penalty(g_r)
    errs = {"g": _rel_err(g_k, g_r), "t": _rel_err(t_k, t_r), "u": _rel_err(u_k, u_r),
            "P": _rel_err(p_k, p_r)}
    bad = {k: v for k, v in errs.items() if v > GP_RTOL}
    if bad:
        raise AssertionError(f"gp forward disagrees at {shape} x{scale}: {bad} (tol {GP_RTOL:g})")

    # Backward, both fed the same q and residuals.
    q = gp.q_from(g_r, n_r, 1.0).contiguous()
    res = (q, m1_r, m2_r, w1, w2, u_r, t_r)
    d_k = gp.mlp_gp_bwd(*res)
    d_r = gp.mlp_gp_bwd_ref(*res)
    d_again = gp.mlp_gp_bwd(*res)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(d_k, d_again)):
        raise AssertionError(f"gp backward at {shape} does not repeat bit for bit")
    grad_errs = {k: _rel_err(a, b) for k, a, b in zip(("dw1", "dw2", "dw3"), d_k, d_r)}
    bad = {k: v for k, v in grad_errs.items() if v > GP_GRAD_RTOL}
    if bad:
        raise AssertionError(f"gp backward disagrees at {shape} x{scale}: {bad} "
                             f"(tol {GP_GRAD_RTOL:g})")
    if zero and not (float(p_k) == 1.0 and all(float(d.abs().max()) == 0 for d in d_k)):
        raise AssertionError("gp dead zone: expected P = 1 and zero gradients")
    fwd_abs = float((g_k - g_r).abs().max())
    bwd_abs = max(float((a - b).abs().max()) for a, b in zip(d_k, d_r))
    log(f"[gp parity] {str(shape):20s} x{scale:<5g}{' zero' if zero else '     '} "
        f"mask flips {flips:2d} | rel err g {errs['g']:.2e} t {errs['t']:.2e} "
        f"P {errs['P']:.2e} | dw1 {grad_errs['dw1']:.2e} dw2 {grad_errs['dw2']:.2e} "
        f"dw3 {grad_errs['dw3']:.2e} | bit-repeatable")
    return fwd_abs, bwd_abs, flips


def phase_gp_parity():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"fwd": 0.0, "bwd": 0.0}
    flips = 0
    for shape, scale, zero in GP_CASES:
        f, b, n = _gp_case(shape, scale, zero, gen)
        worst["fwd"], worst["bwd"] = max(worst["fwd"], f), max(worst["bwd"], b)
        flips += n
    log(f"[gp parity] {len(GP_CASES)} cases pass: max |dg| {worst['fwd']:.3g}, max |ddW| "
        f"{worst['bwd']:.3g}, mask flips {flips} (g, t, P tol {GP_RTOL:g} of max; dW tol "
        f"{GP_GRAD_RTOL:g} of max)")
    return worst


def phase_gp_time(smi):
    """The pair against its plain version at the slice shape (CUDA events),
    beside the bound; the whole penalty (closed form, forward + backward)
    beside the generic double-backward, for scale only."""
    import torch

    from tpugan_torch.nn.blocks import MLPDiscriminator
    from tpugan_torch.ops import mlp_gp as gp
    from tpugan_torch.ops.penalty import wgan_gp_penalty

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    ins = _gp_inputs(GP_SHAPE, 1.0, False, gen)
    g, m1, m2, u, t = gp.mlp_gp_fwd_ref(*ins)
    _, n = gp.norm_penalty(g)
    res = (gp.q_from(g, n, 1.0).contiguous(), m1, m2, ins[1], ins[3], u, t)
    reps = 200
    out = {
        "fwd": {"ms": cuda_ms(lambda: gp.mlp_gp_fwd(*ins), reps),
                "plain_ms": cuda_ms(lambda: gp.mlp_gp_fwd_ref(*ins), reps)},
        "bwd": {"ms": cuda_ms(lambda: gp.mlp_gp_bwd(*res), reps),
                "plain_ms": cuda_ms(lambda: gp.mlp_gp_bwd_ref(*res), reps)},
    }
    b, n0, n1, n2 = GP_SHAPE
    flops = 2 * b * (2 * n0 * n1 + 2 * n1 * n2)  # four products each way
    weights = n1 * n0 + n2 * n1
    nbytes = {
        # x, W1, b1, W2, b2, w3 in; g, m1, t, m2, u out
        "fwd": 4 * (b * n0 + weights + n1 + 2 * n2 + b * n0 + 2 * b * n1 + 2 * b * n2),
        # q, m1, t, m2, u, W1, W2 in; dW1, dW2, dw3 out
        "bwd": 4 * (b * n0 + 2 * b * n1 + 2 * b * n2 + weights + weights + n2),
    }
    for k in ("fwd", "bwd"):
        out[k]["bound_ms"], out[k]["bound_by"] = bound_ms(flops, nbytes[k])
        o = out[k]
        log(f"[gp time] {k} {GP_SHAPE}: kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, "
            f"bound {o['bound_ms']:.4f} ms ({o['bound_by']}: {flops / 1e6:.1f} MFLOP, "
            f"{nbytes[k] / 1e6:.2f} MB), library none ({o['bound_ms'] / o['ms']:.1%} of bound)")

    # Device time of the four launches of each direction (torch.profiler),
    # beside the CUDA-event time above, which also holds the wrapper's host
    # time where the host is the slower side.
    from torch.profiler import ProfilerActivity, profile

    n_prof = 20
    for k, fn in (("fwd", lambda: gp.mlp_gp_fwd(*ins)), ("bwd", lambda: gp.mlp_gp_bwd(*res))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if "gemm_kernel" in e.key:
                us = (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
                args = e.key[e.key.find("<"):e.key.find(">") + 1]
                rows.append((args, e.count, us / n_prof))
        device_ms = sum(r[2] for r in rows) / 1e3
        out[k]["device_ms"] = device_ms if device_ms > 0 else None
        log(f"[gp time] {k} device time per call (torch.profiler, {n_prof} calls): "
            f"{device_ms:.4f} ms = " + ", ".join(f"gemm{r[0]} x{r[1] // n_prof} {r[2]:.1f} us"
                                                 for r in rows))

    # The whole penalty, both ways, on a template-A critic at this shape.
    D = MLPDiscriminator(n0, sigmoid=False).cuda()
    real = torch.rand(b, 1, 28, 28, device="cuda", generator=gen) * 2 - 1
    fake = torch.rand(b, 1, 28, 28, device="cuda", generator=gen) * 2 - 1
    alpha = torch.rand(b, 1, 1, 1, device="cuda", generator=gen)
    leaves = gp.extract_mlp_critic(D)
    x = (alpha * real + (1 - alpha) * fake).reshape(b, -1)

    def closed():
        gp.mlp_grad_penalty(x, *leaves).backward()

    def generic():
        wgan_gp_penalty(D, real, fake, alpha=alpha).backward()

    p_c = float(gp.mlp_grad_penalty(x, *leaves).detach())
    p_g = float(wgan_gp_penalty(D, real, fake, alpha=alpha).detach())
    t_c, t_g = cuda_ms(closed, 50), cuda_ms(generic, 50)
    log(f"[gp time] whole penalty fwd+bwd at batch {b}: closed form (kernels) {t_c:.4f} ms, "
        f"generic double-backward {t_g:.4f} ms; P {p_c:.6f} vs {p_g:.6f} (for scale only)")
    log(f"[gp time] on {torch.cuda.get_device_name(0)} ({smi})")
    return out


def phase_wgan_slice(smi):
    import numpy as np
    import torch

    from tpugan_torch.models import wgan_gp
    from tpugan_torch.ops import mlp_gp as gp

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_wgan_gp_")
    metrics = os.path.join(out_dir, "metrics.jsonl")
    argv = [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(WGAN_BATCHES),
        "--sample_interval", str(WGAN_SAMPLE_INTERVAL), "--output_dir", out_dir,
        "--metrics_jsonl", metrics,
    ]
    gp.reset_launch_counts()
    t0 = time.perf_counter()
    wgan_gp.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": gp.gp_fwd_launches, "bwd": gp.gp_bwd_launches}
    want = {"fwd": WGAN_BATCHES, "bwd": WGAN_BATCHES}
    log(f"[wgan_gp slice] main() took {wall:.1f} s (data, modules, {WGAN_BATCHES} critic steps, "
        f"{WGAN_BATCHES // 5} generator steps, samples); GP launches {launches}, expected {want}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 run with TF32 left on")
    if launches != want:
        raise AssertionError(f"GP launch counts {launches} != expected {want}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != WGAN_BATCHES:
        raise AssertionError(f"{len(rows)} metric rows, expected {WGAN_BATCHES}")
    for row in rows:
        bad = {k: v for k, v in row.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at batch {row['step']}: {bad}")
    g_rows = [r for r in rows if "g_loss" in r]
    log(f"[wgan_gp slice] losses finite in all {len(rows)} rows; first {rows[0]}, last G row "
        f"{g_rows[-1]}")
    want_png = ["%d.png" % k for k in range(0, WGAN_BATCHES, WGAN_SAMPLE_INTERVAL)]
    imgdir = os.path.join(out_dir, "images")
    have = sorted(os.listdir(imgdir), key=lambda p: int(p.split(".")[0]))
    if have != want_png:
        raise AssertionError(f"sample PNGs {have}, expected {want_png}")
    for name in have:
        with open(os.path.join(imgdir, name), "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{name} is not a PNG")
    log(f"[wgan_gp slice] wrote {have}")

    # Steady state: one schedule unit (a d_step, the g_step on its z, four
    # more d_steps) on one fixed uint8 batch on the card.
    cfg = wgan_gp.Config(synthetic_data=True, output_dir=out_dir)
    dev = torch.device("cuda")
    modules = wgan_gp.build(cfg, dev)
    state = wgan_gp.create_state(cfg, modules, dev)
    d_step, g_step = wgan_gp.make_steps(cfg, state)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (cfg.batch_size, cfg.img_size, cfg.img_size, cfg.channels),
                     dtype=np.uint8)).to(dev)
    ev = lambda: torch.cuda.Event(enable_timing=True)

    def unit(marks):
        nonlocal state
        marks[0].record()
        state, d0 = d_step(state, imgs)
        marks[1].record()
        state, g_out = g_step(state, d0["z"])
        marks[2].record()
        for _ in range(cfg.n_critic - 1):
            state, _ = d_step(state, imgs)
        marks[3].record()
        return d0["d_loss"], g_out["g_loss"]

    n_warm, n_timed = 3, 20
    marks = [[ev() for _ in range(4)] for _ in range(n_warm + n_timed)]
    for m in marks[:n_warm]:
        unit(m)
    torch.cuda.synchronize()
    marks = marks[n_warm:]
    t0 = time.perf_counter()
    for m in marks:
        losses = unit(m)
    torch.cuda.synchronize()
    unit_ms = (time.perf_counter() - t0) / n_timed * 1e3
    d_ms = sum(m[0].elapsed_time(m[1]) + m[2].elapsed_time(m[3]) for m in marks) / (
        n_timed * cfg.n_critic)
    g_ms = sum(m[1].elapsed_time(m[2]) for m in marks) / n_timed
    if not all(math.isfinite(float(v)) for v in losses):
        raise AssertionError(f"non-finite losses in the timed units: {losses}")
    images_s = cfg.n_critic * cfg.batch_size / unit_ms * 1e3

    # The device's busy share over a few units (torch.profiler kernel times
    # on the one stream, against the host clock around the window).
    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for m in [[ev() for _ in range(4)] for _ in range(n_prof)]:
            unit(m)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"[wgan_gp slice] profiled {n_prof} units: {len(kernels) / n_prof:.0f} device kernels "
        f"and {busy_ms / n_prof:.3f} ms of device time per unit, in {prof_ms / n_prof:.3f} ms of "
        f"host time (profiler on): device busy {busy_ms / prof_ms:.1%}")
    log(f"[wgan_gp slice] steady state on {torch.cuda.get_device_name(0)} ({smi}): "
        f"{unit_ms:.3f} ms per schedule unit ({cfg.n_critic} d_steps + 1 g_step), "
        f"{d_ms:.3f} ms per d_step, {g_ms:.3f} ms per g_step, {images_s:.0f} critic images/s "
        f"(batch {cfg.batch_size}, fp32, TF32 off; mean of {n_timed} units after 3 warm-up)")
    return launches


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()
    in_worst, in_time = phase_parity()
    in_launches = phase_slice(smi)
    gp_worst = phase_gp_parity()
    gp_time = phase_gp_time(smi)
    gp_launches = phase_wgan_slice(smi)
    in_src, gp_src = "tpugan_torch/csrc/instance_norm.cu", "tpugan_torch/csrc/mlp_gp.cu"
    replaces = {
        "in_act_fwd": "tpugan/ops/pallas_kernels.py:226",
        "in_act_bwd": "tpugan/ops/pallas_kernels.py:237",
        "mlp_gp_fwd": "tpugan/ops/pallas_critic.py:151",
        "mlp_gp_bwd": "tpugan/ops/pallas_critic.py:165",
    }
    kernels = []
    for k in ("fwd", "bwd"):
        t = in_time[k]
        kernels.append({
            "name": f"in_act_{k}", "route": "cuda", "source": in_src,
            "replaces": replaces[f"in_act_{k}"], "launches": in_launches[k],
            "max_abs_err": in_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t.get("library_ms"),
        })
    for k in ("fwd", "bwd"):
        t = gp_time[k]
        kernels.append({
            "name": f"mlp_gp_{k}", "route": "cuda", "source": gp_src,
            "replaces": replaces[f"mlp_gp_{k}"], "launches": gp_launches[k],
            "max_abs_err": gp_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
