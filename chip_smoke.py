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
7. AdaIN parity and time: the AdaIN pair against its plain version on the
   card, forward and backward, at the MUNIT slice's shapes and at a ragged
   H*W, 1x1 planes, a large offset, w with zeros and negatives, and w and
   bias as strided slices through ``adain()``; both directions must repeat
   bit for bit. Then the kernels' times at the slice's two shapes beside the
   plain version, the bound and ``F.instance_norm`` (forward) or
   ``native_batch_norm_backward`` (backward) on the (1, B*C, H, W) view.
8. MUNIT IN parity and time: the instance-norm pair against its plain
   version at every (shape, slope) site of the MUNIT path, the step's and the
   sample grid's, down to the discriminator's 2x2 planes; then the times at
   each site and their sums over one MUNIT step.
9. MUNIT slice: ``tpugan_torch.models.munit.main`` at the reference
   configuration (128px, batch 1, dim 64, 3 residual blocks) for 6 steps
   with samples and checkpoints; checks finite losses, the sample sheets and
   checkpoints, and the exact AdaIN and IN launch counts; then the
   steady-state step time, the step's FLOPs and operations bound, the
   device's busy share and the step's largest device kernels
   (torch.profiler).

The bounds use the published peaks of the card ``nvidia-smi`` names
(``PEAKS``): FP32 outside the tensor cores and HBM bandwidth.

Any failure raises, and the script exits non-zero without the final line.
The last three lines are the kernels' JSON record (every kernel with its
launches on the main path, error, times, bound and library-call time; the IN
pair, which runs on the CycleGAN and the MUNIT paths, also by path),
``nvidia-smi``'s name and power limit, and ``{"ok": true, "device": {...}}``.
Imports no JAX.
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

# AdaIN at the MUNIT slice (128px, batch 1, dim 64, 3 residual blocks): every
# AdaIN of the decoder runs at (B, 256, 32, 32), 6 a decoder call. A step
# makes 4 decoder calls; the sample grid one at batch 40 (5 images x 8
# style codes). IN sites: 9 an encoder call (3 head and down, 6 in the
# residual blocks) and 9 a MultiDiscriminator call; a step makes 4 encoder
# calls and 6 discriminator calls (2 in the G phase, 2 in each D phase), every
# one differentiated; the sample grid makes 1 content-encoder call.
ADAIN_STEP_SHAPE, ADAIN_SAMPLE_SHAPE = (1, 256, 32, 32), (40, 256, 32, 32)
ADAIN_PER_STEP, ADAIN_PER_SAMPLE = 24, 6
# ((B, C, H, W), slope) of every MUNIT instance-norm site and how often one
# step makes it (the sample grid's: per grid). Encoder: the head and down
# convs at slope 1 (ReLU follows unfused), the residual blocks at 0 then 1;
# discriminator towers at 128, 64 and 32 px, LeakyReLU(0.2) fused.
MUNIT_IN_STEP = {
    ((1, 64, 128, 128), 1.0): 4, ((1, 128, 64, 64), 1.0): 4,
    ((1, 256, 32, 32), 1.0): 16, ((1, 256, 32, 32), 0.0): 12,
    ((1, 128, 32, 32), 0.2): 6, ((1, 256, 16, 16), 0.2): 6, ((1, 512, 8, 8), 0.2): 6,
    ((1, 128, 16, 16), 0.2): 6, ((1, 256, 8, 8), 0.2): 6, ((1, 512, 4, 4), 0.2): 6,
    ((1, 128, 8, 8), 0.2): 6, ((1, 256, 4, 4), 0.2): 6, ((1, 512, 2, 2), 0.2): 6,
}
MUNIT_IN_SAMPLE = {
    ((40, 64, 128, 128), 1.0): 1, ((40, 128, 64, 64), 1.0): 1,
    ((40, 256, 32, 32), 1.0): 4, ((40, 256, 32, 32), 0.0): 3,
}
MUNIT_IN_PER_STEP = sum(MUNIT_IN_STEP.values())  # 90
MUNIT_IN_PER_SAMPLE = sum(MUNIT_IN_SAMPLE.values())  # 9
MUNIT_STEPS, MUNIT_SAMPLE_INTERVAL = 6, 5
# (shape, offset, w kind): "normal" w ~ 1 +- 0.3, "zeros" with zeros and
# negatives. Tolerances, kernel against plain: y within 1e-5 * (1 + |offset|)
# * max(1, max|w|), mean within 1e-5 * (1 + |offset|), rstd within 1e-5
# relative; dx, dw and dbias each within 1e-4 of their largest |.| (plus
# 1e-7 where that is 0, as at 1x1 planes).
ADAIN_CASES = [
    (ADAIN_STEP_SHAPE, 0.0, "normal"),
    (ADAIN_SAMPLE_SHAPE, 0.0, "normal"),
    ((2, 8, 31, 31), 0.0, "normal"),  # ragged H*W: the scalar path
    ((2, 4, 1, 1), 0.0, "normal"),  # 1x1 planes: xh = 0
    ((2, 64, 64, 64), 100.0, "normal"),  # mean = 100 * std
    (ADAIN_STEP_SHAPE, 0.0, "zeros"),
]


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


def device_kernels(prof):
    """The device kernels of a torch.profiler run: its CUDA events without
    the user-annotation ranges (``Optimizer.step#Adam.step``), which span
    kernels and would count their time twice."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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

    # Times at every shape of the step (slope 0), then their sums over one
    # step's launches.
    per_step = _in_times("[in time]", [(s, 0.0, n) for s, n in STEP_SHAPES.items()],
                         [(s, 0.0, n) for s, n in SAMPLE_SHAPES.items()], gen)
    return worst, per_step


def _in_times(tag, step_sites, sample_sites, gen):
    """At each (shape, slope, launches) site: the IN pair's times beside the
    plain version's, the bound (8 bytes an element forward, 12 backward) and
    ``F.instance_norm``, the one PyTorch call that computes the slope-1
    forward (CUDA events). Returns their sums over one step's sites."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import instance_norm as tin

    per_step = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for k in ("fwd", "bwd")}
    per_step["fwd"]["library_ms"] = 0.0
    log(f"{tag} shape          slope launches/step  fwd ms  plain   bound  F.inst  "
        "bwd ms  plain   bound")
    for i, (shape, slope, n) in enumerate(step_sites + sample_sites):
        x = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        _, mean, rstd = tin.in_act_fwd_ref(x, EPS, slope)
        reps = max(5, min(200, int(2e8 / x.numel())))
        t = {
            "fwd": (cuda_ms(lambda: tin.in_act_fwd(x, EPS, slope), reps),
                    cuda_ms(lambda: tin.in_act_fwd_ref(x, EPS, slope), reps),
                    bound_ms(0.0, 8 * x.numel())[0]),
            "bwd": (cuda_ms(lambda: tin.in_act_bwd(g, x, mean, rstd, slope), reps),
                    cuda_ms(lambda: tin.in_act_bwd_ref(g, x, mean, rstd, slope), reps),
                    bound_ms(0.0, 12 * x.numel())[0]),
        }
        lib = cuda_ms(lambda: F.instance_norm(x, eps=EPS), reps)
        in_step = i < len(step_sites)
        if in_step:
            for k in ("fwd", "bwd"):
                for key, v in zip(("ms", "plain_ms", "bound_ms"), t[k]):
                    per_step[k][key] += n * v
            per_step["fwd"]["library_ms"] += n * lib
        log(f"{tag} {str(shape):18s} {slope:3g} {n:3d}{'         ' if in_step else ' (sample)'}"
            f" {t['fwd'][0]:7.4f} {t['fwd'][1]:7.4f} {t['fwd'][2]:7.4f} {lib:7.4f}"
            f" {t['bwd'][0]:7.4f} {t['bwd'][1]:7.4f} {t['bwd'][2]:7.4f}")
    f, b = per_step["fwd"], per_step["bwd"]
    log(f"{tag} one step's {sum(n for *_, n in step_sites)} launches: fwd {f['ms']:.3f} ms "
        f"(plain {f['plain_ms']:.3f}, bound {f['bound_ms']:.3f}, F.instance_norm "
        f"{f['library_ms']:.3f}), bwd {b['ms']:.3f} ms (plain {b['plain_ms']:.3f}, bound "
        f"{b['bound_ms']:.3f}, library none)")
    return per_step


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
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"[wgan_gp slice] profiled {n_prof} units: {len(kernels) / n_prof:.0f} device kernels "
        f"and {busy_ms / n_prof:.3f} ms of device time per unit, in {prof_ms / n_prof:.3f} ms of "
        f"host time (profiler on): device busy {busy_ms / prof_ms:.1%}")
    log(f"[wgan_gp slice] steady state on {torch.cuda.get_device_name(0)} ({smi}): "
        f"{unit_ms:.3f} ms per schedule unit ({cfg.n_critic} d_steps + 1 g_step), "
        f"{d_ms:.3f} ms per d_step, {g_ms:.3f} ms per g_step, {images_s:.0f} critic images/s "
        f"(batch {cfg.batch_size}, fp32, TF32 off; mean of {n_timed} units after 3 warm-up)")
    return launches


def _adain_inputs(shape, offset, w_kind, gen):
    import torch

    b, c = shape[:2]
    x = torch.randn(shape, device="cuda", generator=gen) + offset
    g = torch.randn(shape, device="cuda", generator=gen)
    w = 1.0 + 0.3 * torch.randn((b, c), device="cuda", generator=gen)
    if w_kind == "zeros":
        w[:, ::3] = 0.0
        w[:, 1::3] *= -1.0
    bias = 0.3 * torch.randn((b, c), device="cuda", generator=gen)
    return x, w, bias, g


def _adain_errors(got, want, offset, w):
    """Largest errors of (y, mean, rstd, dx, dw, db), kernel against plain;
    raises past the tolerances of ``ADAIN_CASES``."""
    y_k, mean_k, rstd_k, *grads_k = got
    y_r, mean_r, rstd_r, *grads_r = want
    y_tol = Y_ATOL * (1.0 + abs(offset)) * max(1.0, float(w.abs().max()))
    errs = {
        "y": float((y_k - y_r).abs().max()),
        "mean": float((mean_k - mean_r).abs().max()),
        "rstd": float(((rstd_k - rstd_r).abs() / rstd_r).max()),
    }
    tols = {"y": y_tol, "mean": Y_ATOL * (1.0 + abs(offset)), "rstd": Y_ATOL}
    for name, a, b in zip(("dx", "dw", "db"), grads_k, grads_r):
        errs[name] = float((a - b).abs().max())
        tols[name] = DX_RTOL * float(b.abs().max()) + 1e-7
    bad = {k: (errs[k], tols[k]) for k in errs if not errs[k] <= tols[k]}
    return errs, bad


def phase_adain_parity():
    import torch

    from tpugan_torch.ops import adain as ta

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, offset, w_kind in ADAIN_CASES:
        x, w, bias, g = _adain_inputs(shape, offset, w_kind, gen)
        fwd = ta.adain_fwd(x, w, bias, EPS)
        fwd_again = ta.adain_fwd(x, w, bias, EPS)
        y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w, bias, EPS)
        bwd = ta.adain_bwd(g, x, w, mean_r, rstd_r)
        bwd_again = ta.adain_bwd(g, x, w, mean_r, rstd_r)
        bwd_r = ta.adain_bwd_ref(g, x, w, mean_r, rstd_r)
        torch.cuda.synchronize()
        for name, a, b in (("forward", fwd, fwd_again), ("backward", bwd, bwd_again)):
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                raise AssertionError(f"adain {name} at {shape} does not repeat bit for bit")
        errs, bad = _adain_errors((*fwd, *bwd), (y_r, mean_r, rstd_r, *bwd_r), offset, w)
        if bad:
            raise AssertionError(f"adain disagrees at {shape} offset {offset} w {w_kind}: "
                                 f"{bad} (error, tolerance)")
        worst["fwd"] = max(worst["fwd"], errs["y"])
        worst["bwd"] = max(worst["bwd"], errs["dx"], errs["dw"], errs["db"])
        log(f"[adain parity] {str(shape):18s} offset {offset:<5g} w {w_kind:6s} | "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " | bit-repeatable")

    # w and bias as strided slices of the style MLP's output, through the
    # autograd Function, as the AdaIN residual block takes them.
    b, c = ADAIN_SAMPLE_SHAPE[:2]
    x, _, _, g = _adain_inputs(ADAIN_SAMPLE_SHAPE, 0.0, "normal", gen)
    params = 0.5 + 0.5 * torch.randn((b, 4 * c), device="cuda", generator=gen)
    params.requires_grad_()
    xg = x.clone().requires_grad_()
    w_s, b_s = params[:, c:2 * c], params[:, :c]
    if w_s.is_contiguous() or b_s.is_contiguous():
        raise AssertionError("the strided case's slices are contiguous")
    y = ta.adain(xg, w_s, b_s, EPS)
    y.backward(g)
    w_c, b_c = w_s.detach().contiguous(), b_s.detach().contiguous()
    y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w_c, b_c, EPS)
    dx_r, dw_r, db_r = ta.adain_bwd_ref(g, x, w_c, mean_r, rstd_r)
    dp_r = torch.zeros_like(params)
    dp_r[:, :c], dp_r[:, c:2 * c] = db_r, dw_r
    torch.cuda.synchronize()
    errs = {"y": float((y.detach() - y_r).abs().max()),
            "dx": float((xg.grad - dx_r).abs().max()),
            "dparams": float((params.grad - dp_r).abs().max())}
    tols = {"y": Y_ATOL * max(1.0, float(w_c.abs().max())),
            "dx": DX_RTOL * float(dx_r.abs().max()), "dparams": DX_RTOL * float(dp_r.abs().max())}
    bad = {k: (errs[k], tols[k]) for k in errs if not errs[k] <= tols[k]}
    if bad:
        raise AssertionError(f"adain() on strided w/bias slices disagrees: {bad}")
    worst["fwd"] = max(worst["fwd"], errs["y"])
    worst["bwd"] = max(worst["bwd"], errs["dx"], errs["dparams"])
    log(f"[adain parity] strided w/bias slices of a {tuple(params.shape)} tensor through "
        f"adain(): y {errs['y']:.2e} dx {errs['dx']:.2e} dparams {errs['dparams']:.2e}")
    log(f"[adain parity] {len(ADAIN_CASES) + 1} cases pass: max |dy| {worst['fwd']:.3g}, max "
        f"|d(dx, dw, db)| {worst['bwd']:.3g}")
    return worst


def phase_adain_time(smi):
    """At the slice's two shapes: kernel, plain version, bound and the
    PyTorch call that computes the same function on the (1, B*C, H, W) view,
    forward and backward, CUDA events; then forward + backward through
    autograd beside ``F.instance_norm``'s. The step's sums are over its 24
    launches at ``ADAIN_STEP_SHAPE``."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import adain as ta

    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for shape in (ADAIN_STEP_SHAPE, ADAIN_SAMPLE_SHAPE):
        x, w, bias, g = _adain_inputs(shape, 0.0, "normal", gen)
        b, c, h, wd = shape
        planes, n = b * c, x.numel()
        _, mean, rstd = ta.adain_fwd_ref(x, w, bias, EPS)
        x1, g1 = x.view(1, planes, h, wd), g.view(1, planes, h, wd)
        w1, b1 = w.flatten(), bias.flatten()

        def lib_fwd():
            return F.instance_norm(x1, weight=w1, bias=b1, eps=EPS)

        def lib_bwd():
            return torch.ops.aten.native_batch_norm_backward(
                g1, x1, w1, None, None, mean, rstd, True, EPS, [True, True, True])

        # The yardsticks must compute the same function: held to the plain
        # version as the kernels are.
        lib = (lib_fwd(), *lib_bwd())
        plain = (ta.adain_fwd_ref(x, w, bias, EPS)[0], *ta.adain_bwd_ref(g, x, w, mean, rstd))
        lib_err = max(float((a.reshape(r.shape) - r).abs().max()) / max(1.0, float(r.abs().max()))
                      for a, r in zip(lib, plain))
        if lib_err > DX_RTOL:
            raise AssertionError(f"the library calls differ from AdaIN at {shape}: {lib_err:.3g}")
        reps = max(20, min(200, int(2e8 / n)))
        t = {
            "fwd": {"ms": cuda_ms(lambda: ta.adain_fwd(x, w, bias, EPS), reps),
                    "plain_ms": cuda_ms(lambda: ta.adain_fwd_ref(x, w, bias, EPS), reps),
                    "library_ms": cuda_ms(lib_fwd, reps)},
            "bwd": {"ms": cuda_ms(lambda: ta.adain_bwd(g, x, w, mean, rstd), reps),
                    "plain_ms": cuda_ms(lambda: ta.adain_bwd_ref(g, x, w, mean, rstd), reps),
                    "library_ms": cuda_ms(lib_bwd, reps)},
        }
        # Bytes: x in and y out, w and bias in and mean and rstd out per plane;
        # g and x in and dx out, w, mean and rstd in and dw and dbias out.
        # Operations: 8 a forward element (sum; centred square; normalise and
        # affine), 9 a backward element (xh; the two sums; dx).
        for k, nbytes, flops in (("fwd", 8 * n + 16 * planes, 8 * n),
                                 ("bwd", 12 * n + 20 * planes, 9 * n)):
            t[k]["bound_ms"], t[k]["bound_by"] = bound_ms(flops, nbytes)

        xg = x.clone().requires_grad_()
        wg, bg = w.clone().requires_grad_(), bias.clone().requires_grad_()
        x1g = x1.clone().requires_grad_()
        w1g, b1g = w1.clone().requires_grad_(), b1.clone().requires_grad_()
        both = cuda_ms(lambda: ta.adain(xg, wg, bg, EPS).backward(g), reps)
        both_lib = cuda_ms(
            lambda: F.instance_norm(x1g, weight=w1g, bias=b1g, eps=EPS).backward(g1), reps)
        out[shape] = t
        for k in ("fwd", "bwd"):
            o = t[k]
            log(f"[adain time] {k} {str(shape):18s} kernel {o['ms']:.4f} ms, plain "
                f"{o['plain_ms']:.4f}, bound {o['bound_ms']:.4f} ({o['bound_by']}), library "
                f"{o['library_ms']:.4f} ({o['bound_ms'] / o['ms']:.1%} of bound)")
        log(f"[adain time] fwd+bwd {str(shape):14s} through autograd: adain() {both:.4f} ms, "
            f"F.instance_norm {both_lib:.4f} ms")
    step = {k: {key: ADAIN_PER_STEP * v for key, v in out[ADAIN_STEP_SHAPE][k].items()
                if key != "bound_by"} for k in ("fwd", "bwd")}
    for k in ("fwd", "bwd"):
        step[k]["bound_by"] = out[ADAIN_STEP_SHAPE][k]["bound_by"]
        o = step[k]
        log(f"[adain time] one step's {ADAIN_PER_STEP} {k} launches: kernel {o['ms']:.3f} ms, "
            f"plain {o['plain_ms']:.3f}, bound {o['bound_ms']:.3f}, library {o['library_ms']:.3f}")
    log(f"[adain time] on {torch.cuda.get_device_name(0)} ({smi})")
    return step


def phase_munit_in():
    """The IN pair against its plain version at every (shape, slope) of the
    MUNIT path, forward and backward; then the times at each site and their
    sums over one MUNIT step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"fwd": 0.0, "bwd": 0.0}
    sites = list(MUNIT_IN_STEP) + list(MUNIT_IN_SAMPLE)
    for shape, slope in sites:
        y_err, dx_err = _parity_case(shape, slope, 0.0, gen)
        worst["fwd"] = max(worst["fwd"], y_err)
        worst["bwd"] = max(worst["bwd"], dx_err)
    log(f"[munit in parity] {len(sites)} sites pass: max |dy| {worst['fwd']:.3g}, max |ddx| "
        f"{worst['bwd']:.3g} (y tol {Y_ATOL:g}, dx tol {DX_RTOL:g} of max|dx|)")
    per_step = _in_times("[munit in time]", [(s, sl, n) for (s, sl), n in MUNIT_IN_STEP.items()],
                         [(s, sl, n) for (s, sl), n in MUNIT_IN_SAMPLE.items()], gen)
    return worst, per_step


def phase_munit_slice(smi):
    import numpy as np
    import torch

    from tpugan_torch.models import munit
    from tpugan_torch.ops import adain as ta
    from tpugan_torch.ops import instance_norm as tin

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_munit_")
    metrics = os.path.join(out_dir, "metrics.jsonl")
    argv = [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(MUNIT_STEPS),
        "--sample_interval", str(MUNIT_SAMPLE_INTERVAL), "--checkpoint_interval", "1",
        "--output_dir", out_dir, "--metrics_jsonl", metrics,
    ]
    ta.reset_launch_counts()
    tin.reset_launch_counts()
    t0 = time.perf_counter()
    munit.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"adain_fwd": ta.adain_fwd_launches, "adain_bwd": ta.adain_bwd_launches,
                "in_fwd": tin.fwd_launches, "in_bwd": tin.bwd_launches}
    log("")
    n_samples = len(range(0, MUNIT_STEPS, MUNIT_SAMPLE_INTERVAL))
    want = {
        "adain_fwd": MUNIT_STEPS * ADAIN_PER_STEP + n_samples * ADAIN_PER_SAMPLE,
        "adain_bwd": MUNIT_STEPS * ADAIN_PER_STEP,
        "in_fwd": MUNIT_STEPS * MUNIT_IN_PER_STEP + n_samples * MUNIT_IN_PER_SAMPLE,
        "in_bwd": MUNIT_STEPS * MUNIT_IN_PER_STEP,
    }
    log(f"[munit slice] main() took {wall:.1f} s (data, modules, {MUNIT_STEPS} steps, "
        f"{n_samples} samples); launches {launches}, expected {want}")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 run with TF32 left on")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != MUNIT_STEPS:
        raise AssertionError(f"{len(rows)} metric rows, expected {MUNIT_STEPS}")
    for row in rows:
        bad = {k: v for k, v in row.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {row['step']}: {bad}")
    log(f"[munit slice] losses finite at all {MUNIT_STEPS} steps; last: {rows[-1]}")
    imgs = os.path.join(out_dir, "images", "edges2shoes")
    ckpts = os.path.join(out_dir, "saved_models", "edges2shoes")
    pngs = [os.path.join(imgs, f"{i}.png") for i in range(0, MUNIT_STEPS, MUNIT_SAMPLE_INTERVAL)]
    pths = [os.path.join(ckpts, f"{m}_0.pth") for m in munit.MODULES]
    missing = [p for p in pngs + pths if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"missing outputs: {missing}")
    cfg = munit.Config(synthetic_data=True, output_dir=out_dir)
    # A sheet of 5 rows, each a validation image and its style_dim
    # translations, with the grid's 2-pixel border.
    sheet_wh = ((cfg.style_dim + 1) * cfg.img_width + 4, 5 * cfg.img_height + 4)
    for path in pngs:
        with open(path, "rb") as f:
            head = f.read(24)
        wh = (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"))
        if head[:8] != b"\x89PNG\r\n\x1a\n" or wh != sheet_wh:
            raise AssertionError(f"{path}: not a {sheet_wh} PNG sheet (size {wh})")
    for path in pths:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if not all(torch.isfinite(v).all() for v in sd.values()):
            raise AssertionError(f"non-finite weights in {os.path.basename(path)}")
    log(f"[munit slice] wrote samples {[os.path.basename(p) for p in pngs]} ({sheet_wh[0]}x"
        f"{sheet_wh[1]} sheets) and checkpoints {[os.path.basename(p) for p in pths]}, "
        f"all finite")

    # Steady state: the same entry points, one fixed uint8 batch on the card.
    dev = torch.device("cuda")
    modules = munit.build(cfg, dev)
    state = munit.create_state(cfg, modules, dev)
    step = munit.make_step(cfg, modules, dev)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, cfg.img_height, cfg.img_width, 3),
                                          dtype=np.uint8)).to(dev) for _ in range(2))
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

    # The operations bound of a step: its convolutions and matmuls, forward
    # and backward, counted from the shapes, at the FP32 peak.
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        state, out = step(state, a, b)
    flops = counter.get_total_flops()
    log(f"[munit slice] one step's convolutions and matmuls: {flops / 1e12:.4f} TFLOP forward "
        f"and backward (torch.utils.flop_counter), {bound_ms(flops, 0)[0]:.2f} ms at the FP32 "
        f"peak")

    # The device's busy share and its largest kernels over a few steps
    # (torch.profiler, one stream, against the host clock around the window).
    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            state, out = step(state, a, b)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    log(f"[munit slice] profiled {n_prof} steps: {len(kernels) / n_prof:.0f} device kernels and "
        f"{busy_ms / n_prof:.3f} ms of device time per step, in {prof_ms / n_prof:.3f} ms of host "
        f"time (profiler on): device busy {busy_ms / prof_ms:.1%}")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[munit slice]   {tot / n_prof:9.3f} ms/step  x{cnt / n_prof:5.0f}  {name[:110]}")
    # The port's own kernels: in_act_{fwd,bwd}_kernel<kVec, kAffine>.
    ours = {}
    for name, (tot, cnt) in by_name.items():
        for k in ("fwd", "bwd"):
            if f"in_act_{k}_kernel<" in name:
                key = ("adain_" if name.split("<")[1].split(">")[0].endswith("true") else "in_") + k
                t, c = ours.get(key, (0.0, 0))
                ours[key] = (t + tot / n_prof, c + cnt // n_prof)
    log("[munit slice] the port's kernels, device time per step: " + ", ".join(
        f"{k} {t:.3f} ms x{c}" for k, (t, c) in sorted(ours.items())))
    log(f"[munit slice] steady state on {torch.cuda.get_device_name(0)} ({smi}): "
        f"{step_ms:.2f} ms/step, {cfg.batch_size * 1e3 / step_ms:.2f} images/s (128px, batch 1, "
        f"dim 64, 3 blocks, fp32, TF32 off; mean of {n_timed} steps after 3 warm-up)")
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
    adain_worst = phase_adain_parity()
    adain_time = phase_adain_time(smi)
    munit_in_worst, munit_in_time = phase_munit_in()
    munit_launches = phase_munit_slice(smi)
    in_src, gp_src = "tpugan_torch/csrc/instance_norm.cu", "tpugan_torch/csrc/mlp_gp.cu"
    replaces = {
        "in_act_fwd": "tpugan/ops/pallas_kernels.py:226",
        "in_act_bwd": "tpugan/ops/pallas_kernels.py:237",
        "mlp_gp_fwd": "tpugan/ops/pallas_critic.py:151",
        "mlp_gp_bwd": "tpugan/ops/pallas_critic.py:165",
        "adain_fwd": "tpugan/ops/pallas_kernels.py:343",
        "adain_bwd": "tpugan/ops/pallas_kernels.py:354",
    }
    kernels = []
    for k in ("fwd", "bwd"):
        # The IN pair runs on two paths. Its launches and error cover both;
        # its times are one CycleGAN step's, and by_path keeps each path's
        # own launches, error and times over one step of that path.
        by_path = {
            path: {"launches": n, "max_abs_err": worst[k], "ms": t[k]["ms"],
                   "plain_ms": t[k]["plain_ms"], "bound_ms": t[k]["bound_ms"],
                   "library_ms": t[k].get("library_ms"), "times_of": times_of}
            for path, n, worst, t, times_of in (
                ("cyclegan", in_launches[k], in_worst, in_time,
                 f"one cyclegan step, {FWD_PER_STEP} launches"),
                ("munit", munit_launches[f"in_{k}"], munit_in_worst, munit_in_time,
                 f"one munit step, {MUNIT_IN_PER_STEP} launches"))
        }
        c = by_path["cyclegan"]
        kernels.append({
            "name": f"in_act_{k}", "route": "cuda", "source": in_src,
            "replaces": replaces[f"in_act_{k}"],
            "launches": in_launches[k] + munit_launches[f"in_{k}"],
            "max_abs_err": max(in_worst[k], munit_in_worst[k]), "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": "bytes",
            "library_ms": c["library_ms"], "times_of": c["times_of"], "by_path": by_path,
        })
    for k in ("fwd", "bwd"):
        t = gp_time[k]
        kernels.append({
            "name": f"mlp_gp_{k}", "route": "cuda", "source": gp_src,
            "replaces": replaces[f"mlp_gp_{k}"], "launches": gp_launches[k],
            "max_abs_err": gp_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        })
    for k in ("fwd", "bwd"):
        t = adain_time[k]
        kernels.append({
            "name": f"adain_{k}", "route": "cuda", "source": in_src,
            "replaces": replaces[f"adain_{k}"], "launches": munit_launches[f"adain_{k}"],
            "max_abs_err": adain_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
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
