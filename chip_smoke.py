#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpugan_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card. Phases:

1. device: the card's name and power limit, the TF32 flags, whether the
   native host pipeline is built;
2. build: every CUDA kernel of the port from ``tpugan_torch/csrc`` (one nvcc
   per source, started together), with ptxas's registers and spills;
   launch cost: the host time of one IN or AdaIN launch and of its parts,
   beside the library calls, at the MUNIT step shape, and of the GP
   wrappers and their parts at the WGAN-GP shape (``host_us``);
3. IN parity and time: the instance-norm pair against its plain PyTorch
   version on the card, forward and backward, at every shape the CycleGAN
   slice gives it and at slopes 0.0, 0.2 and 1.0, plus ragged planes and a
   large-offset case, each repeating bit for bit; at each step shape the
   kernels' times (CUDA events) beside the plain version's, the bound, and
   the library call on the (1, B*C, H, W) view (``F.instance_norm`` forward,
   ``native_batch_norm_backward`` backward), then the device time per call
   of the kernels and the library calls (torch.profiler);
4. CycleGAN slice: ``tpugan_torch.models.cyclegan.main`` at 256px, batch 1,
   9 residual blocks, fp32, for 6 steps with samples and checkpoints; checks
   finite losses, the output files, and that every instance-norm site went
   through the kernels (launch counters); then the steady-state step time;
5. GP parity and time: the closed-form WGAN-GP pair against its plain
   version on the card at seven cases (batches 1 to 256), each repeating bit
   for bit; then both directions at the slice shape: the launch plan, CUDA
   events beside the plain version and the bound, device time per kernel
   (torch.profiler; every device kernel inside a wrapper call must be one of
   ``mlp_gp.cu``'s, four forward and two backward), the time per call of
   calls replayed from a CUDA graph (``graph_ms``: device time with the gaps
   between launches, without the host), programmatic dependent launch on
   and off in turns, the same eight products as ``torch.mm`` calls (cuBLAS,
   TF32 off) as a yardstick for the products alone, and the generic
   double-backward penalty for scale;
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
   ``native_batch_norm_backward`` (backward) on the (1, B*C, H, W) view,
   CUDA events and device time.
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
10. im2im IN parity and time: the instance-norm pair against its plain
   version at every (shape, slope) site of the five im2im paths (pix2pix,
   discogan, dualgan, context_encoder, ccgan: ``IM2IM_IN``), their steps'
   and samplers', down to discogan's 32,768 2x2 planes at batch 64; the pair
   captured in a CUDA graph at a plane split over a cluster, replayed bit
   for bit; then the times at each site of one step of each path (dualgan:
   a d_step and a g_step) and their sums (``[im2im in parity]``, ``[im2im
   in time]``).
11. im2im slices: ``pix2pix.main`` (256px, batch 1), ``discogan.main``
   (64px, batch 64) and ``dualgan.main`` (128px, batch 8, n_critic 5), each
   at its reference configuration for 5-6 batches, eager: finite losses,
   each PNG by name and grid size, each checkpoint by the reference's name,
   the exact IN launches; then the steady-state step (dualgan: schedule
   unit) time, device time, IN device time and busy share (``[pix2pix
   slice]``, ``[discogan slice]``, ``[dualgan slice]``).
12. DCGAN slice: ``tpugan_torch.models.dcgan.main`` at 64px, batch 64, with
   synthetic data for 40 batches with samples, and ``lsgan.main`` at its
   defaults (32px, batch 64) for 20; checks finite losses, the sample PNGs
   and that neither launched any of the port's kernels (the JAX path
   reaches no Pallas kernel). Then, for the DCGAN step at 64px and at 32px:
   steady-state ms a step and images/s, the step's FLOPs and FP32 bound, the
   device's busy share, the largest device kernels, and the kernels each
   cuDNN convolution ran (its algorithm; an FFT is flagged).
13. Fused dispatch (``--steps_per_dispatch``, one CUDA graph of K steps,
   replayed): ``dcgan.main`` at 64px with K = 60 over 3 epochs of 64
   batches, ``wgan_gp.main`` with K = 10 schedule units over 2 epochs of 50
   batches (the GP pair inside the graph) and ``wgan.main`` at its reference
   configuration (batch 64, 28x28, n_critic 5) over 3, each also unfused for
   one epoch of 50; each checks finite losses, the metric rows and PNGs, and the graph's
   replays. WGAN-GP's GP launches on the device (wrapper calls not captured,
   plus captured calls times replays) must be one each way per critic step,
   and a profiled replay must hold the kernels of that many. Then for each,
   replay against eager from the same seed (bit for bit where two eager runs
   are, else within twice their difference; DCGAN also with cuDNN held
   deterministic, bit for bit), and the eager and the graphed ms a step (or
   unit), images/s, the capture's and instantiation's host time, the memory
   around the capture and the busy share of a replay.
14. The rest of the critic family and the conditional family, each at its
   reference configuration (batch 64; gan and wgan_div at 28x28 with latent
   100, dragan, cgan, acgan and sgan at 32x32 with latent 100 and 10
   classes, infogan at 32x32 with latent 62 and code 2): each ``main``
   unfused for one epoch, then fused over two epochs with a tail (K = 20
   steps a graph through ``run_training``; wgan_div K = 10 units through
   ``run_critic_family``); finite losses at every row, every PNG by name and
   grid size (infogan's three folders, dragan's per-epoch grids), no launch
   of the port's kernels (these paths reach no Pallas kernel in the JAX
   package); then replay against eager (run_training trainers: cuDNN held
   deterministic, bit for bit; wgan_div: shipped settings, as wgan's), and
   the eager and graphed ms a step (``[gan fused]``, ``[dragan fused]``, ``[wgan_div fused]``,
   ``[cgan fused]``, ``[acgan fused]``, ``[sgan fused]``, ``[infogan
   fused]``).
15. The inpainting pair fused: ``context_encoder.main`` (128px, 64px mask,
   batch 8) and ``ccgan.main`` (128px, 32px mask, batch 8) unfused for one
   epoch of 25 batches, then with K = 10 steps a graph over two: the IN
   pair's launches on the device (calls not captured plus captured calls
   times replays), 6 each way a step; replay against eager with cuDNN held
   deterministic, bit for bit; eager and graphed ms a step
   (``[context_encoder fused]``, ``[ccgan fused]``).
16. stargan, unit and pixelda IN parity and time: the instance-norm pair
   against its plain version at every (shape, slope) site of each path, the
   steps' and the samplers' (stargan's batch-50 sheet, unit's batch-5),
   repeating bit for bit, then the times over one step of each
   (``[stargan in parity]``/``[stargan in time]``, likewise unit, pixelda).
17. stargan and unit slices: ``stargan.main`` (128px, batch 16, 6 residual
   blocks, n_critic 5) for 5 batches and ``unit.main`` (256px, batch 1, dim
   64) for 6, eager: finite losses, the sheets, the checkpoints reloaded,
   the exact IN launches; then the steady state (stargan's d_step and
   g_step apart) and the peak memory (``[stargan slice]``, ``[unit
   slice]``); the tracked IN's train-mode buffers and eval forward against
   plain PyTorch (``[stargan tracked in]``).
18. The two-domain pair fused: ``pixelda.main`` (32px, batch 64) and
   ``cogan.main`` (32px, batch 32) over the MNIST/MNIST-M ``ZipLoader``, as
   the inpainting pair: pixelda's IN launches on the device (18 forward, 15
   backward a step), cogan's none; replay bit for bit against eager with
   cuDNN deterministic; eager and graphed ms a step (``[pixelda fused]``,
   ``[cogan fused]``).
19. The rest of templates A and B fused, each as phase 14's run_training
   trainers at its reference configuration (batch 64; bgan and softmax_gan
   at 28x28 with latent 100, relativistic_gan at 32x32 with latent 100,
   ebgan and began at 32x32 with latent 62, aae at 32x32 with latent 10 and
   its 10x10 sheet), K = 20: every PNG by name and grid size, no launch of
   the port's kernels, replay bit for bit against eager with cuDNN held
   deterministic (began's equilibrium term k, carried in ``state.aux``,
   among the tensors), eager and graphed ms a step (``[bgan fused]``,
   ``[softmax_gan fused]``, ``[relativistic_gan fused]``, ``[ebgan
   fused]``, ``[began fused]``, ``[aae fused]``).
20. cluster_gan slice: ``cluster_gan.main`` at the reference configuration
   (28px, batch 64, latent 30, n_critic 5), eager (its own host loop), in
   both ``--wass_flag`` branches for two epochs of ``CLUSTER_BATCHES``:
   finite losses at every row, the three sheets an epoch by name and grid
   size, no launch of the port's kernels; then the steady-state schedule
   unit (one full_step, four d_steps): ms a step, device time and busy
   share (``[cluster_gan slice]``).
21. The last four entries, eager, each at its reference configuration on
   synthetic data: ``bicyclegan.main`` (128px, batch 8, latent 8) for 6
   batches with a sample sheet and its four checkpoints; ``srgan.main`` (HR
   256, batch 4, 16 residual blocks, the He-random VGG19 features[:18]) and
   ``esrgan.main`` (HR 256, batch 4, 23 RRDB blocks, VGG19 features[:35];
   2 warm-up batches, previews every 2, a checkpoint every 4 batches) for
   6; each with finite losses, its PNGs by name and size, its checkpoints
   reloaded and no launch of the port's kernels; then the steady-state
   step (esrgan's warm-up and full step apart, and the full step's FLOPs
   and share of the FP32 peak), device time, busy share, kernels and peak
   memory (``[bicyclegan slice]``, ``[srgan slice]``, ``[esrgan slice]``).
   ``python -m tpugan_torch test_on_image`` on a 64x64 PNG with the esrgan
   slice's generator: a 260x260 PNG equal to the loaded generator's
   forward, quantized (``[test_on_image]``).
22. DCGAN bench: ``tpugan_torch.bench`` (64px, batch 64, fp32, one CUDA graph
   of 60 steps replayed), its JSON line printed before a ``[fused summary]``
   line and the last three lines.

Each phase prints its seconds (``[phase seconds]``), and the script its
whole (``[script seconds]``).

The bounds use the published peaks of the card ``nvidia-smi`` names
(``PEAKS``): FP32 outside the tensor cores and HBM bandwidth.

Any failure raises, and the script exits non-zero without the final line.
The last three lines are the kernels' JSON record (every kernel with its
launches on the main path, error, times, device time, bound and library-call
time; the IN pair, which runs on the CycleGAN, MUNIT and eight im2im paths,
three of them inside replayed CUDA graphs, and the GP pair, which runs eager
and inside the replayed WGAN-GP unit, also by path),
``nvidia-smi``'s name and power limit, and ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
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
    ((65, 784, 512, 256), 1.0, False),  # a second row tile of one row
    ((256, 784, 512, 256), 1.0, False),  # four row tiles, the largest batch
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
# The template-B slice: DCGAN at the headline's 64px, batch 64, and LSGAN at
# its defaults (32px, batch 64).
DCGAN_BATCHES, DCGAN_SAMPLE_INTERVAL = 40, 20
LSGAN_BATCHES, LSGAN_SAMPLE_INTERVAL = 20, 10
# The fused dispatch: DCGAN at 64px with the headline's 60 steps a CUDA
# graph, over three epochs of the synthetic set's 64 batches (a dispatch and
# a tail of 4 eager steps each); the critic family with 10 schedule units (50
# batches) a graph, one dispatch an epoch: WGAN-GP over 2 epochs (100
# batches), wgan over 3 (150).
DCGAN_K, DCGAN_FUSED_EPOCHS, DCGAN_EPOCH_BATCHES = 60, 3, 64
WGAN_K, WGAN_FUSED_EPOCHS, WGAN_PLAIN_FUSED_EPOCHS = 10, 2, 3
# The rest of the critic family and the conditional family, each at its
# reference configuration: the run_training trainers (gan, dragan, cgan,
# acgan, sgan, infogan) unfused for one epoch of 30 batches, then with K = 20
# steps a graph over two epochs of 30 (a dispatch and a tail of 10 each);
# wgan_div unfused for one epoch of 53 batches, then with K = 10 units (50
# batches) a graph over two (a tail of 3 each).
RECIPE_K, RECIPE_EPOCH_BATCHES, RECIPE_SAMPLE_INTERVAL = 20, 30, 10
CLUSTER_BATCHES = 15  # a cluster_gan epoch in [cluster_gan slice]
WDIV_K, WDIV_TAIL = 10, 3
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
    ((1, 64, 128, 128), 0.0, "zeros"),  # clusters of 4 CTAs a plane, both ways
]
# Calls a host time of the [launch cost] phase is taken over.
LAUNCH_CALLS = 2000

# ((B, C, H, W), slope) of every instance-norm site of the five im2im paths
# and how often one unit makes it, recorded from a CPU run of each unit at
# batch 1 (``tests/test_torch_port_in_plan.py`` records them again): the
# leading dimension is the batch's multiple (2 where a discriminator sees
# the real and the fake batch in one forward), scaled by ``IM2IM_BATCH`` in
# ``im2im_sites``; a sampler's shapes are its own. Every step site is
# differentiated (a d_step's and a sampler's are forward only). pix2pix and
# discogan fuse IN with LeakyReLU(0.2) (slope 0.2) and with ReLU (slope 0);
# dualgan's affine IN is the kernel at slope 1 with the affine after it; the
# inpainting pair's IN is its discriminator's, LeakyReLU(0.2) fused.
IM2IM_BATCH = {"pix2pix": 1, "discogan": 64, "dualgan": 8, "context_encoder": 8, "ccgan": 8}
_P2P_G = {(128, 64, 0.2): 1, (256, 32, 0.2): 1, (512, 16, 0.2): 1, (512, 8, 0.2): 1,
          (512, 4, 0.2): 1, (512, 2, 0.2): 1, (512, 2, 0.0): 1, (512, 4, 0.0): 1,
          (512, 8, 0.0): 1, (512, 16, 0.0): 1, (256, 32, 0.0): 1, (128, 64, 0.0): 1,
          (64, 128, 0.0): 1}
_DISCO_G = {(128, 16, 0.2): 1, (256, 8, 0.2): 1, (512, 4, 0.2): 1, (512, 2, 0.2): 1,
            (512, 2, 0.0): 1, (512, 4, 0.0): 1, (256, 8, 0.0): 1, (128, 16, 0.0): 1,
            (64, 32, 0.0): 1}
_DUAL_G = {(128, 32, 1.0): 2, (256, 16, 1.0): 2, (512, 8, 1.0): 2, (512, 4, 1.0): 2,
           (512, 2, 1.0): 2, (64, 64, 1.0): 1}


def _sites(b, per, times=1):
    """{((b, C, H, W), slope): n * times} from {(C, H, slope): n}."""
    return {((b, c, h, h), slope): n * times for (c, h, slope), n in per.items()}


def _add_sites(*dicts):
    out = {}
    for d in dicts:
        for k, n in d.items():
            out[k] = out.get(k, 0) + n
    return out


IM2IM_IN = {
    # G once; D on (fake, real_a) in the G phase, on the real and fake pairs
    # in one forward in the D phase (``models/pix2pix.py:make_step``).
    "pix2pix": {"step": _add_sites(_sites(1, _P2P_G),
                                   _sites(1, {(128, 64, 0.2): 1, (256, 32, 0.2): 1,
                                              (512, 16, 0.2): 1}),
                                   _sites(2, {(128, 64, 0.2): 1, (256, 32, 0.2): 1,
                                              (512, 16, 0.2): 1})),
                "sample": _sites(10, _P2P_G)},
    # Four generator forwards; D_A and D_B once each in the G phase and on
    # [real; fake] in their own.
    "discogan": {"step": _add_sites(_sites(1, _DISCO_G, 4),
                                    _sites(1, {(128, 16, 0.2): 1, (256, 8, 0.2): 1}, 2),
                                    _sites(2, {(128, 16, 0.2): 1, (256, 8, 0.2): 1}, 2)),
                 "sample": _sites(16, _DISCO_G, 2)},
    # The critics are BatchNorm: the generators' IN only, twice a d_step
    # (forward only, the fakes detached) and four times a g_step.
    "dualgan": {"d_step": _sites(1, _DUAL_G, 2), "g_step": _sites(1, _DUAL_G, 4),
                "sample": _sites(16, _DUAL_G, 2)},
    # The discriminator on the generated patch (G phase), then on [real;
    # fake] patches; the generators are BatchNorm.
    "context_encoder": {"step": _add_sites(
        _sites(1, {(128, 16, 0.2): 1, (256, 8, 0.2): 1}), _sites(2, {(128, 16, 0.2): 1,
                                                                     (256, 8, 0.2): 1}),
        {((1, 512, 8, 8), 0.2): 1, ((2, 512, 8, 8), 0.2): 1})},
    "ccgan": {"step": _add_sites(
        _sites(1, {(128, 32, 0.2): 1, (256, 16, 0.2): 1, (512, 16, 0.2): 1}),
        _sites(2, {(128, 32, 0.2): 1, (256, 16, 0.2): 1, (512, 16, 0.2): 1}))},
}
IM2IM_BWD_UNITS = ("step", "g_step")  # the units whose every site is differentiated
IM2IM_PATHS = ("pix2pix", "discogan", "dualgan", "context_encoder", "ccgan")

# The IN sites of the three paths PR 11 adds, recorded likewise
# (``tests/test_torch_port_in_plan.py`` records them again, stargan and unit
# at a smaller image size and scaled). stargan (128px, batch 16): 17 tracked
# affine INs a generator forward, the kernel at slope 1; a d_step makes one
# forward, not differentiated, a g_step two; the sample sheet one at batch
# 50 (10 images x 5 translations). unit (256px, batch 1): an encoder call
# makes 11 sites (IN+LeakyReLU(0.2) after the c7, IN+ReLU after each down,
# the four residual blocks' IN+ReLU and IN), a generator call 10, a
# discriminator call 3 (IN+LeakyReLU(0.2)); a step makes 4 encoder, 6
# generator and 6 discriminator calls, every one differentiated; the sheet
# two of each network at batch 5. pixelda (32px, batch 64): plain IN after
# LeakyReLU at 8x8, 4x4 and 2x2 in the discriminator and the classifier
# blocks, 5 differentiated calls a step and one forward only (the
# classifier's accuracy on MNIST-M, ``telemetry``).
_STAR_G = {(64, 128, 1.0): 2, (128, 64, 1.0): 2, (256, 32, 1.0): 13}
_UNIT_E = {(64, 256, 0.2): 1, (128, 128, 0.0): 1, (256, 64, 0.0): 5, (256, 64, 1.0): 4}
_UNIT_G = {(256, 64, 0.0): 4, (256, 64, 1.0): 4, (128, 128, 0.2): 1, (64, 256, 0.2): 1}
_UNIT_D = {(128, 64, 0.2): 1, (256, 32, 0.2): 1, (512, 16, 0.2): 1}
_PIXELDA_BLOCKS = {(128, 8, 1.0): 1, (256, 4, 1.0): 1, (512, 2, 1.0): 1}
IM2IM_BATCH.update(stargan=16, unit=1, pixelda=64)
IM2IM_IN.update({
    "stargan": {"d_step": _sites(1, _STAR_G), "g_step": _sites(1, _STAR_G, 2),
                "sample": _sites(50, _STAR_G)},
    "unit": {"step": _add_sites(_sites(1, _UNIT_E, 4), _sites(1, _UNIT_G, 6),
                                _sites(1, _UNIT_D, 6)),
             "sample": _add_sites(_sites(5, _UNIT_E, 2), _sites(5, _UNIT_G, 2))},
    "pixelda": {"step": _sites(1, _PIXELDA_BLOCKS, 5), "telemetry": _sites(1, _PIXELDA_BLOCKS)},
})
NEW_IN_PATHS = ("stargan", "unit", "pixelda")
# The units of one timed step of each path (stargan: a batch with a g_step).
IN_TIMED_UNITS = {"pix2pix": ("step",), "discogan": ("step",), "dualgan": ("d_step", "g_step"),
                  "context_encoder": ("step",), "ccgan": ("step",),
                  "stargan": ("d_step", "g_step"), "unit": ("step",),
                  "pixelda": ("step", "telemetry")}


def im2im_sites(path: str, unit: str) -> dict:
    """The sites of a unit at the path's reference batch."""
    b = 1 if unit == "sample" else IM2IM_BATCH[path]
    return {((s[0] * b, *s[1:]), slope): n for (s, slope), n in IM2IM_IN[path][unit].items()}


def im2im_per_unit(path: str, unit: str, direction: str) -> int:
    """IN launches of one unit of a path, forward or backward."""
    if direction == "bwd" and unit not in IM2IM_BWD_UNITS:
        return 0
    return sum(IM2IM_IN[path][unit].values())


def timed_sites(path: str) -> list:
    """(shape, slope, forward launches, backward launches) of every site of
    one timed step of a path (``IN_TIMED_UNITS``), at its reference batch."""
    out = {}
    for unit in IN_TIMED_UNITS[path]:
        for site, n in im2im_sites(path, unit).items():
            f, b = out.get(site, (0, 0))
            out[site] = (f + n, b + (n if unit in IM2IM_BWD_UNITS else 0))
    return [(shape, slope, f, b) for (shape, slope), (f, b) in out.items()]


# The im2im slices, each main at its reference configuration: batches, and
# the sample interval (pix2pix and discogan sample at batch 0 and 5, dualgan
# at 0 and 4: two of its five batches take a g_step).
IM2IM_SLICE = {"pix2pix": (6, 5), "discogan": (6, 5), "dualgan": (5, 4)}
# The inpainting pair fused: unfused one epoch of 25 batches, then with K =
# 10 steps a CUDA graph over two (two dispatches and a tail of 5 each).
INPAINT_K, INPAINT_EPOCH_BATCHES, INPAINT_SAMPLE_INTERVAL = 10, 25, 10


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


def device_ms(fn, reps: int):
    """Device time per call in ms from torch.profiler over ``reps`` calls.
    ``cuda_ms`` of the same calls also holds the host's time wherever the
    host is the slower side. Every call launches the same kernels, so the
    time per call is, for each kernel name, its mean duration times its
    launches per call (its count over reps, rounded): the sum over reps
    divided by reps when the trace is whole, and still the time per call
    when the profiler drops events, as it does in some sessions on the H100
    machine (4-5 in 100 in a fresh process, most of them late in one run).
    None (not measured) where no event came back in 3 tries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in device_kernels(prof):
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        if by_name:
            return sum(tot / n * max(1, round(n / reps)) for tot, n in by_name.values()) / 1e3
    return None


def graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Time per call in ms of ``calls`` calls captured in one CUDA graph and
    replayed ``replays`` times (CUDA events): the device's time including the
    gaps between launches, without the host's launch time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def add_ms(total, n, t):
    """total + n * t, where a time that was not measured (None) makes the
    sum not measured too."""
    return None if total is None or t is None else total + n * t


def fmt_ms(t, width: int = 7) -> str:
    return f"{t:{width}.4f}" if t is not None else "n/m".rjust(width)


def host_us(fn, calls: int = LAUNCH_CALLS) -> float:
    """Host time per call in µs: ``time.perf_counter_ns`` around ``calls``
    calls after 50 of warm-up, then one synchronize outside the clock."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


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
    spills = [m for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                    info.log) if m != ("0", "0")]
    log(f"[build] kernels with spills: {len(spills)}")


def phase_launch_cost(smi):
    """Host time of one launch and of its parts, µs a call (``host_us``), at
    the MUNIT step shape: the whole ``adain_bwd`` and ``in_act_fwd``
    wrappers, ``AdaIN.apply`` forward and backward, the bare ctypes call, the
    allocations, the stream lookup, the checks and the plan; the parts the
    wrappers did before their redesign; and the library calls beside them."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import _build
    from tpugan_torch.ops import adain as ta
    from tpugan_torch.ops import instance_norm as tin

    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = ADAIN_STEP_SHAPE
    x, w, bias, g = _adain_inputs(shape, 0.0, "normal", gen)
    b, c, h, wd = shape
    planes, hw = b * c, h * wd
    dev = x.get_device()
    _, mean, rstd = ta.adain_fwd_ref(x, w, bias, EPS)
    _, plan_arg = tin._plan_arg(planes, hw, "bwd")
    lib = _build.library()
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
    stats = x.new_empty((2, planes))
    ptrs = (g.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr())
    args = (*ptrs, 1.0, plan_arg, tin.raw_stream(dev))
    # A plan of no planes: the C entry returns before any CUDA call.
    no_launch = (*ptrs, 1.0, ctypes.byref(_build.LaunchPlan(0, hw, 1, 0, 0, 32)), args[-1])
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, bias))
    x1, g1 = x.view(1, planes, h, wd), g.view(1, planes, h, wd)
    w1, b1 = w.flatten(), bias.flatten()

    def lookup_before():  # a function-level import and library() at every launch
        from tpugan_torch.ops._build import library

        return library()

    def checks_before():  # device, dtype and contiguity, one test at a time
        for t in (g, x, mean, rstd, w):
            if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
                raise AssertionError("unexpected input")

    rows = [
        ("adain_bwd wrapper", lambda: ta.adain_bwd(g, x, w, mean, rstd)),
        ("in_act_fwd wrapper", lambda: tin.in_act_fwd(x, EPS, 0.0)),
        ("AdaIN.apply forward + backward", lambda: ta.adain(xg, wg, bg, EPS).backward(g)),
        ("bare ctypes call (in_act_bwd, prepared arguments)", lambda: lib.in_act_bwd(*args)),
        ("  the same, refused in C before any CUDA call", lambda: lib.in_act_bwd(*no_launch)),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("x.new_empty(B*C), torch.empty_like: mean, rstd",
         lambda: torch.empty_like(x.new_empty(planes))),
        ("torch.empty_like(w) twice: dw, dbias", lambda: (torch.empty_like(w),
                                                          torch.empty_like(w))),
        ("one allocation instead: x.new_empty((2, B*C))", lambda: x.new_empty((2, planes))),
        ("  and the unbind of its two rows", stats.unbind),
        ("raw stream (torch._C)", lambda: tin.raw_stream(dev)),
        ("checks, one pass over 5 tensors", lambda: _build.check_tensors(
            "adain_bwd", dev, g, x, mean, rstd, w)),
        ("plan and its C struct from their cache", lambda: tin._plan_arg(planes, hw, "bwd")),
        ("before: import and library() lookup", lookup_before),
        ("before: torch.empty(B*C) twice", lambda: (torch.empty(planes, device=x.device),
                                                    torch.empty(planes, device=x.device))),
        ("before: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        ("before: checks, device, dtype, contiguity a tensor", checks_before),
        ("F.instance_norm (AdaIN forward's library call)",
         lambda: F.instance_norm(x1, weight=w1, bias=b1, eps=EPS)),
        ("native_batch_norm_backward (AdaIN backward's)",
         lambda: torch.ops.aten.native_batch_norm_backward(
             g1, x1, w1, None, None, mean, rstd, True, EPS, [True, True, True])),
    ]
    out = {}
    for name, fn in rows:
        out[name] = host_us(fn)
        log(f"[launch cost] {name:52s} {out[name]:8.3f} us/call")
    log(f"[launch cost] host clock, {LAUNCH_CALLS} calls after warm-up, at {shape}; on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    for name, fn in _gp_launch_rows(gen, dev):
        out[name] = host_us(fn)
        log(f"[launch cost] {name:52s} {out[name]:8.3f} us/call")
    log(f"[launch cost] the GP rows at {GP_SHAPE}, same clock")
    return out


def _gp_launch_rows(gen, dev):
    """[launch cost] rows of the GP pair at the slice shape: the whole
    wrappers, the bare ctypes call, its parts, and the parts the wrapper
    took before its redesign (six allocations, ``current_stream``, checks a
    tensor at a time)."""
    import ctypes

    import torch

    from tpugan_torch.ops import _build
    from tpugan_torch.ops import mlp_gp as gp

    ins = _gp_inputs(GP_SHAPE, 1.0, False, gen)
    x = ins[0]
    g, m1, m2, u, t = gp.mlp_gp_fwd_ref(*ins)
    q = gp.q_from(g, gp.norm_penalty(g)[1], 1.0).contiguous()
    res = (q, m1, m2, ins[1], ins[3], u, t)
    b, n0, n1, n2 = GP_SHAPE
    lib = _build.library()
    _, _, cp = gp._plan_arg(b, n0, n1, n2, "fwd", gp.PDL)
    outs = [torch.empty_like(a) for a in (g, m1, m2, u, t)]
    ptrs = [a.data_ptr() for a in (*ins, *outs)]
    stream = gp._bind()[2](dev)
    # A plan of batch 0: the C entry returns before any CUDA call.
    empty = gp._c_plan(gp.plan(*GP_SHAPE, "fwd")._replace(shape=(0, n0, n1, n2)))
    empty_arg = ctypes.byref(empty)

    def checks_before():  # device, dtype and contiguity, one test at a time
        for a in ins:
            if a.device.type != "cuda" or a.dtype != torch.float32 or not a.is_contiguous():
                raise AssertionError("unexpected input")

    return [
        ("mlp_gp_fwd wrapper (4 launches)", lambda: gp.mlp_gp_fwd(*ins)),
        ("mlp_gp_bwd wrapper (2 launches)", lambda: gp.mlp_gp_bwd(*res)),
        ("bare ctypes call (mlp_gp_fwd, 13 arguments)", lambda: lib.mlp_gp_fwd(*ptrs, cp, stream)),
        ("  the same, refused in C before any CUDA call",
         lambda: lib.mlp_gp_fwd(*ptrs, empty_arg, stream)),
        ("five x.new_empty: g, m1, t, m2, u", lambda: (
            x.new_empty((b, n0)), x.new_empty((b, n1)), x.new_empty((b, n1)),
            x.new_empty((b, n2)), x.new_empty((b, n2)))),
        ("checks, one pass over 6 tensors", lambda: _build.check_tensors("mlp_gp_fwd", dev, *ins)),
        ("plan and its C struct from their cache",
         lambda: gp._plan_arg(b, n0, n1, n2, "fwd", gp.PDL)),
        ("eleven data_ptr() calls", lambda: [a.data_ptr() for a in (*ins, *outs)]),
        ("before: six torch.empty(shape, device=...)", lambda: [
            torch.empty(shape, device=x.device, dtype=torch.float32)
            for shape in ((b, n0), (b, n1), (b, n2), (b, n2), (b, n1), (b, n1))]),
        ("before: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        ("before: checks a tensor at a time, 6 tensors", checks_before),
    ]


def _parity_case(shape, slope, offset, gen):
    import torch

    from tpugan_torch.ops import instance_norm as tin

    x = torch.randn(shape, device="cuda", generator=gen) + offset
    g = torch.randn(shape, device="cuda", generator=gen)
    y_k, mean_k, rstd_k = tin.in_act_fwd(x, EPS, slope)
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, EPS, slope)
    dx_k = tin.in_act_bwd(g, x, mean_r, rstd_r, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean_r, rstd_r, slope)
    again = (*tin.in_act_fwd(x, EPS, slope), tin.in_act_bwd(g, x, mean_r, rstd_r, slope))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, (y_k, mean_k, rstd_k, dx_k))):
        raise AssertionError(f"IN at {shape} slope {slope} does not repeat bit for bit")
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
    cases += [((3, 5, 1, 7), sl, 0.0) for sl in SLOPES]  # a warp a ragged plane
    cases += [((2, 64, 64, 64), sl, 100.0) for sl in SLOPES]  # mean = 100 * std
    for shape, slope, offset in cases:
        y_err, dx_err = _parity_case(shape, slope, offset, gen)
        worst["fwd"] = max(worst["fwd"], y_err)
        worst["bwd"] = max(worst["bwd"], dx_err)
    log(f"[in parity] {len(cases)} cases pass, each repeating bit for bit: max |dy| "
        f"{worst['fwd']:.3g}, max |ddx| {worst['bwd']:.3g} (y tol {Y_ATOL:g}*(1+|offset|), dx "
        f"tol {DX_RTOL:g} of max|dx|)")

    # Times at every shape of the step (slope 0), then their sums over one
    # step's launches.
    per_step = _in_times("[in time]", [(s, 0.0, n) for s, n in STEP_SHAPES.items()],
                         [(s, 0.0, n) for s, n in SAMPLE_SHAPES.items()], gen)
    return worst, per_step


def _in_times(tag, step_sites, sample_sites, gen):
    """At each (shape, slope, launches) site, or (shape, slope, forward
    launches, backward launches) where a step differentiates only some of
    its calls: the IN pair's times beside the
    plain version's, the bound (8 bytes an element forward, 12 backward) and
    the PyTorch call that computes the slope-1 function on the (1, B*C, H, W)
    view, ``F.instance_norm`` forward and ``native_batch_norm_backward``
    backward (CUDA events); then the device time per call of the kernels and
    of the library calls (``device_ms``). The library calls are first held to
    the plain slope-1 version. Returns the sums over one step's sites."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import instance_norm as tin

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "library_device_ms")
    per_step = {k: dict.fromkeys(keys, 0.0) for k in ("fwd", "bwd")}
    log(f"{tag} shape          slope launches/step | fwd ms  plain   bound   library  device "
        "lib dev | bwd ms  plain   bound   library  device lib dev")
    for i, (shape, slope, *n) in enumerate(step_sites + sample_sites):
        n = {"fwd": n[0], "bwd": n[-1]}
        x = torch.randn(shape, device="cuda", generator=gen)
        g = torch.randn(shape, device="cuda", generator=gen)
        _, mean, rstd = tin.in_act_fwd_ref(x, EPS, slope)
        b, c, h, wd = shape
        x1, g1 = x.view(1, b * c, h, wd), g.view(1, b * c, h, wd)

        def lib_fwd():
            return F.instance_norm(x, eps=EPS)

        def lib_bwd():
            return torch.ops.aten.native_batch_norm_backward(
                g1, x1, None, None, None, mean, rstd, True, EPS, [True, False, False])[0]

        plain = (tin.in_act_fwd_ref(x, EPS, 1.0)[0], tin.in_act_bwd_ref(g, x, mean, rstd, 1.0))
        lib_err = max(_rel_err(a.reshape(r.shape), r) for a, r in zip((lib_fwd(), lib_bwd()), plain))
        if lib_err > DX_RTOL:
            raise AssertionError(f"the library calls differ from slope-1 IN at {shape}: "
                                 f"{lib_err:.3g}")
        reps = max(5, min(200, int(2e8 / x.numel())))
        fns = {"fwd": (lambda: tin.in_act_fwd(x, EPS, slope),
                       lambda: tin.in_act_fwd_ref(x, EPS, slope), lib_fwd),
               "bwd": (lambda: tin.in_act_bwd(g, x, mean, rstd, slope),
                       lambda: tin.in_act_bwd_ref(g, x, mean, rstd, slope), lib_bwd)}
        t = {}
        for k, nbytes in (("fwd", 8 * x.numel()), ("bwd", 12 * x.numel())):
            kern, ref, lib = fns[k]
            t[k] = {"ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(ref, reps),
                    "bound_ms": bound_ms(0.0, nbytes)[0], "library_ms": cuda_ms(lib, reps),
                    "device_ms": device_ms(kern, reps), "library_device_ms": device_ms(lib, reps)}
        in_step = i < len(step_sites)
        if in_step:
            for k in ("fwd", "bwd"):
                for key in keys:
                    per_step[k][key] = add_ms(per_step[k][key], n[k], t[k][key])
        count = f"{n['fwd']:3d}" if n["fwd"] == n["bwd"] else f"{n['fwd']}/{n['bwd']}"
        log(f"{tag} {str(shape):18s} {slope:3g} {count:>5s}{'       ' if in_step else ' (sample)'} | "
            + " | ".join(" ".join(fmt_ms(t[k][key]) for key in keys) for k in ("fwd", "bwd")))
    for k, lib in (("fwd", "F.instance_norm"), ("bwd", "native_batch_norm_backward")):
        o = per_step[k]
        launches = sum(n[0 if k == "fwd" else -1] for _, _, *n in step_sites)
        log(f"{tag} one step's {launches} {k} launches: {o['ms']:.3f} ms "
            f"(plain {o['plain_ms']:.3f}, bound {o['bound_ms']:.3f}, {lib} {o['library_ms']:.3f}); "
            f"device time {fmt_ms(o['device_ms'], 0)} ms, {lib} {fmt_ms(o['library_device_ms'], 0)}")
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
    for k, direction in (("fwd", "fwd"), ("bwd", "bwd")):
        p = gp.plan(*GP_SHAPE, direction, gp.PDL)
        log(f"[gp time] {k} plan: launches bn {p.bn}, CTAs {p.grid}, smem {p.smem} B, PDL "
            f"{p.pdl}; " + ", ".join(f"{q.name} ks {q.ks} kc {q.kc} CTAs {q.ctas}"
                                     for q in p.products))

    # Device time of each direction's launches (torch.profiler): every
    # device kernel inside a wrapper call must be one of mlp_gp.cu's, four
    # forward and two backward, nothing of cuBLAS or cuDNN. Taken in plain
    # stream order: under programmatic dependent launch a kernel starts
    # early and waits, so the profiler's durations overlap; the shipped
    # plan's time per call is graph_ms below.
    from torch.profiler import ProfilerActivity, profile

    n_prof = 20
    want_kernels = {"fwd": 4, "bwd": 2}
    shipped, gp.PDL = gp.PDL, False
    for k, fn in (("fwd", lambda: gp.mlp_gp_fwd(*ins)), ("bwd", lambda: gp.mlp_gp_bwd(*res))):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler drops every event in some runs (device_ms)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n_prof):
                    fn()
                torch.cuda.synchronize()
            events = device_kernels(prof)
            if events:
                break
        foreign = sorted({e.name for e in events if "gp_gemm<" not in e.name})
        if foreign:
            raise AssertionError(f"gp {k}: device kernels other than mlp_gp.cu's: {foreign}")
        by_name = {}
        for e in events:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
        if len(events) > want_kernels[k] * n_prof:
            raise AssertionError(f"gp {k}: {len(events)} device kernels in {n_prof} calls, "
                                 f"expected {want_kernels[k]} a call")
        # Per kernel name: mean duration times launches a call, as device_ms.
        rows = [(name[name.find("<"):name.find(">") + 1], max(1, round(cnt / n_prof)), tot / cnt)
                for name, (tot, cnt) in by_name.items()]
        dev = sum(n * us for _, n, us in rows) / 1e3
        out[k]["device_ms"] = dev if rows else None
        log(f"[gp time] {k} device time per call (torch.profiler, {n_prof} calls in stream "
            f"order, {len(events)} kernels): {dev:.4f} ms = "
            + ", ".join(f"gp_gemm{r[0]} x{r[1]} {r[2]:.2f} us" for r in rows))

    gp.PDL = shipped

    # Calls replayed from a CUDA graph: the device's time per call with the
    # gaps between launches, without the host's launch time.
    for k, fn in (("fwd", lambda: gp.mlp_gp_fwd(*ins)), ("bwd", lambda: gp.mlp_gp_bwd(*res))):
        out[k]["graph_ms"] = graph_ms(fn)
        log(f"[gp time] {k} replayed from a CUDA graph: {out[k]['graph_ms']:.4f} ms per call")

    # Yardstick for the products only: the same eight products as torch.mm
    # calls (cuBLAS, TF32 off), device time, never called by the port.
    x, w1, _, w2, _, _ = ins
    q, m1, m2, _, _, u, t = res
    a1 = (x @ w1.T + ins[2]).relu_()  # any (B, N1) operand: only the time is kept
    s_ = q @ w1.T
    mm = {"fwd": (lambda: x @ w1.T, lambda: a1 @ w2.T, lambda: u @ w2, lambda: t @ w1),
          "bwd": (lambda: q @ w1.T, lambda: t.T @ q, lambda: u.T @ s_, lambda: s_ @ w2.T)}
    for k in ("fwd", "bwd"):
        times = [device_ms(f, 50) for f in mm[k]]
        out[k]["cublas_products_device_ms"] = (None if None in times else sum(times))
        log(f"[gp time] {k} yardstick: the four products as torch.mm (cuBLAS, TF32 off), device "
            f"time {fmt_ms(out[k]['cublas_products_device_ms'], 0)} ms = "
            + " + ".join(fmt_ms(t_, 0) for t_ in times) + " (products only, no epilogues)")

    # Programmatic dependent launch against plain stream order, in turns
    # (on, off, off, on): replayed from a CUDA graph, CUDA events, and
    # torch.profiler's kernel durations, which overlap when it is on.
    pdl_rows = {}
    for pdl in (True, False, False, True):
        gp.PDL = pdl
        for k, fn in (("fwd", lambda: gp.mlp_gp_fwd(*ins)), ("bwd", lambda: gp.mlp_gp_bwd(*res))):
            pdl_rows.setdefault((pdl, k), []).append(
                (graph_ms(fn), cuda_ms(fn, reps), device_ms(fn, reps)))
    gp.PDL = shipped
    for (pdl, k), vals in sorted(pdl_rows.items(), key=lambda kv: (kv[0][1], not kv[0][0])):
        log(f"[gp time] {k} PDL {'on ' if pdl else 'off'}: graph "
            + ", ".join(f"{v[0]:.4f}" for v in vals) + " ms; CUDA events "
            + ", ".join(f"{v[1]:.4f}" for v in vals) + " ms; device "
            + ", ".join(fmt_ms(v[2], 0) for v in vals) + " ms")

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
        for k, kern, lib in (("fwd", lambda: ta.adain_fwd(x, w, bias, EPS), lib_fwd),
                             ("bwd", lambda: ta.adain_bwd(g, x, w, mean, rstd), lib_bwd)):
            t[k]["device_ms"] = device_ms(kern, reps)
            t[k]["library_device_ms"] = device_ms(lib, reps)
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
                f"{o['library_ms']:.4f} ({o['bound_ms'] / o['ms']:.1%} of bound); device time "
                f"kernel {fmt_ms(o['device_ms'], 0)}, library {fmt_ms(o['library_device_ms'], 0)}")
        log(f"[adain time] fwd+bwd {str(shape):14s} through autograd: adain() {both:.4f} ms, "
            f"F.instance_norm {both_lib:.4f} ms")
    step = {k: {key: add_ms(0.0, ADAIN_PER_STEP, v) for key, v in out[ADAIN_STEP_SHAPE][k].items()
                if key != "bound_by"} for k in ("fwd", "bwd")}
    for k in ("fwd", "bwd"):
        step[k]["bound_by"] = out[ADAIN_STEP_SHAPE][k]["bound_by"]
        o = step[k]
        log(f"[adain time] one step's {ADAIN_PER_STEP} {k} launches: kernel {o['ms']:.3f} ms, "
            f"plain {o['plain_ms']:.3f}, bound {o['bound_ms']:.3f}, library {o['library_ms']:.3f}"
            f"; device time kernel {fmt_ms(o['device_ms'], 0)}, library "
            f"{fmt_ms(o['library_device_ms'], 0)}")
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
    # The port's own kernels: in_act_{fwd,bwd}_warp<kAffine> (regime A) and
    # in_act_{fwd,bwd}_slice<kVec, kAffine> (regime B).
    ours = {}
    for name, (tot, cnt) in by_name.items():
        for k in ("fwd", "bwd"):
            if f"in_act_{k}_warp<" in name or f"in_act_{k}_slice<" in name:
                key = ("adain_" if name.split("<")[1].split(">")[0].endswith("true") else "in_") + k
                t, c = ours.get(key, (0.0, 0))
                ours[key] = (t + tot / n_prof, c + cnt // n_prof)
    log("[munit slice] the port's kernels, device time per step: " + ", ".join(
        f"{k} {t:.3f} ms x{c}" for k, (t, c) in sorted(ours.items())))
    log(f"[munit slice] steady state on {torch.cuda.get_device_name(0)} ({smi}): "
        f"{step_ms:.2f} ms/step, {cfg.batch_size * 1e3 / step_ms:.2f} images/s (128px, batch 1, "
        f"dim 64, 3 blocks, fp32, TF32 off; mean of {n_timed} steps after 3 warm-up)")
    return launches


def _port_launches():
    """Every launch counter of the port's kernels."""
    from tpugan_torch.ops import adain as ta
    from tpugan_torch.ops import instance_norm as tin
    from tpugan_torch.ops import mlp_gp as gp

    return {"in_fwd": tin.fwd_launches, "in_bwd": tin.bwd_launches,
            "in_fwd_captured": tin.fwd_captured, "in_bwd_captured": tin.bwd_captured,
            "adain_fwd": ta.adain_fwd_launches, "adain_bwd": ta.adain_bwd_launches,
            "gp_fwd": gp.gp_fwd_launches, "gp_bwd": gp.gp_bwd_launches,
            "gp_fwd_captured": gp.gp_fwd_captured, "gp_bwd_captured": gp.gp_bwd_captured}


def _reset_port_launches():
    from tpugan_torch.ops import adain as ta
    from tpugan_torch.ops import instance_norm as tin
    from tpugan_torch.ops import mlp_gp as gp

    for mod in (ta, tin, gp):
        mod.reset_launch_counts()


def _check_rows(tag, metrics, n_batches) -> list:
    """The metric rows of steps 0..n_batches-1, every value finite."""
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(n_batches)):
        raise AssertionError(f"{tag}: metric rows for steps {[r['step'] for r in rows]}")
    for row in rows:
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"{tag}: non-finite losses at step {row['step']}: {row}")
    return rows


def _check_grids(tag, paths, grid_wh) -> None:
    """Each of ``paths`` is a PNG of ``grid_wh`` (width, height)."""
    for path in paths:
        with open(path, "rb") as f:
            head = f.read(24)
        wh = (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"))
        if head[:8] != b"\x89PNG\r\n\x1a\n" or wh != grid_wh:
            raise AssertionError(f"{tag}: {path} is not a {grid_wh} PNG grid (size {wh})")


def _check_mnist_run(tag, out_dir, metrics, n_batches, interval, img_size, batch):
    """Finite losses at every step and a 5-a-row grid of the first 25 images
    at every sample step."""
    rows = _check_rows(tag, metrics, n_batches)
    n = min(25, batch)
    grid_wh = (5 * (img_size + 2) + 2, -(-n // 5) * (img_size + 2) + 2)
    pngs = [os.path.join(out_dir, "images", f"{i}.png") for i in range(0, n_batches, interval)]
    _check_grids(tag, pngs, grid_wh)
    log(f"{tag} losses finite at all {n_batches} steps (last {rows[-1]}); wrote "
        f"{[os.path.basename(p) for p in pngs]}, {grid_wh[0]}x{grid_wh[1]} grids")


def _dcgan_step_report(smi, img_size):
    """Steady state of the DCGAN step at ``img_size``, batch 64, through the
    trainer's entry points: host-clock time a step, FLOPs and FP32 bound,
    the device's busy share, the largest device kernels and the kernels each
    cuDNN convolution ran."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from tpugan_torch.models import dcgan

    tag = f"[dcgan slice {img_size}px]"
    cfg = dcgan.Config(img_size=img_size, synthetic_data=True)
    dev = torch.device("cuda")
    modules = dcgan.build(cfg, dev)
    state = dcgan.create_state(cfg, modules, dev)
    step = dcgan.make_step(cfg, state)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, img_size, img_size, 1),
                                         dtype=np.uint8)).to(dev)
    for _ in range(5):
        state, out = step(state, imgs)
    torch.cuda.synchronize()
    n_timed = 50
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, out = step(state, imgs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    losses = {k: float(out[k]) for k in ("d_loss", "g_loss")}
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{tag} non-finite losses in the timed steps: {losses}")

    with FlopCounterMode(display=False) as counter:
        state, out = step(state, imgs)
    flops = counter.get_total_flops()
    bound = bound_ms(flops, 0)[0]
    log(f"{tag} one step's convolutions and matmuls: {flops / 1e9:.3f} GFLOP forward and "
        f"backward (torch.utils.flop_counter), {bound:.3f} ms at the FP32 peak: at most "
        f"{cfg.batch_size * 1e3 / bound:.0f} images/s")

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            state, out = step(state, imgs)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    log(f"{tag} profiled {n_prof} steps: {len(kernels) / n_prof:.0f} device kernels and "
        f"{busy_ms / n_prof:.3f} ms of device time per step, in {prof_ms / n_prof:.3f} ms of host "
        f"time (profiler on): device busy {busy_ms / prof_ms:.1%}")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"{tag}   {tot / n_prof:8.4f} ms/step  x{cnt / n_prof:4.0f}  {name[:110]}")
    # The kernels each convolution ran, forward and backward, by its input
    # and weight shapes: their names give cuDNN's algorithm.
    convs = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels and (
                "cudnn_convolution" in e.name or "convolution_backward" in e.name):
            shapes = "x".join(str(tuple(s)) for s in e.input_shapes[:2])
            per = convs.setdefault((e.name, shapes), {})
            for k in e.kernels:
                per[k.name] = per.get(k.name, 0.0) + k.duration / 1e3
    fft = []
    for (op, shapes), per in sorted(convs.items(), key=lambda kv: -sum(kv[1].values())):
        log(f"{tag}   conv {op} {shapes}: {sum(per.values()) / n_prof:.4f} ms/step")
        for name, t in sorted(per.items(), key=lambda kv: -kv[1]):
            is_fft = "fft" in name.lower() or "cf32" in name
            fft += [name] if is_fft else []
            log(f"{tag}     {t / n_prof:8.4f} ms/step  {'FFT ' if is_fft else ''}{name[:100]}")
    if not convs:
        log(f"{tag}   no convolution op carried its kernels in this trace: algorithms not "
            f"measured")
    log(f"{tag} FFT convolution kernels: {sorted(set(fft)) or 'none'}")
    log(f"{tag} steady state on {torch.cuda.get_device_name(0)} ({smi}): {step_ms:.3f} ms/step, "
        f"{cfg.batch_size * 1e3 / step_ms:.1f} images/s ({img_size}px, batch {cfg.batch_size}, "
        f"fp32, TF32 off; mean of {n_timed} steps after 5 warm-up; host clock, synchronized)")


def phase_dcgan_slice(smi):
    import torch

    from tpugan_torch.models import dcgan, lsgan

    for tag, mod, size, n_batches, interval in (
            ("[dcgan slice]", dcgan, 64, DCGAN_BATCHES, DCGAN_SAMPLE_INTERVAL),
            ("[lsgan slice]", lsgan, 32, LSGAN_BATCHES, LSGAN_SAMPLE_INTERVAL)):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_")
        metrics = os.path.join(out_dir, "metrics.jsonl")
        argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", str(n_batches),
                "--sample_interval", str(interval), "--log_interval", "10",
                "--output_dir", out_dir, "--metrics_jsonl", metrics]
        if size != mod.Config.img_size:
            argv += ["--img_size", str(size)]
        _reset_port_launches()
        t0 = time.perf_counter()
        mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _port_launches()
        log(f"{tag} main() took {wall:.1f} s ({size}px, batch 64: data, modules, {n_batches} "
            f"steps, samples); the port's kernel launches {launches}, expected none")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("fp32 run with TF32 left on")
        if any(launches.values()):
            raise AssertionError(f"{tag} launched the port's kernels: {launches}")
        _check_mnist_run(tag, out_dir, metrics, n_batches, interval, size, 64)
    for size in (64, 32):
        _dcgan_step_report(smi, size)


def phase_dcgan_bench():
    """The headline bench; its JSON line stays above the last three lines."""
    from tpugan_torch import bench

    log(f"[dcgan bench] python -m tpugan_torch.bench (DCGAN 64px, batch 64, fp32, cuda_graph, "
        f"K={bench.STEPS}):")
    rec = bench.main()
    if not (rec["metric"] == bench.METRIC and rec["value"] > 0
            and rec["unit"] == "images/sec/gpu" and rec["card"]
            and rec["mode"] == "cuda_graph" and rec["steps_per_dispatch"] == 60):
        raise AssertionError(f"[dcgan bench] unexpected record {rec}")
    return rec


def _snapshot(state) -> dict:
    """Every tensor of a train state on the host: parameters, buffers, the
    state of every optimizer (infogan's third one too), the loop-carried
    ``aux`` tensors (began's k), the generator's state and the step count."""
    import torch

    snap = {"draws": state.draws.get_state(), "step": torch.tensor(state.step)}
    for role, m in state.modules.items():
        for k, v in m.state_dict().items():
            snap[f"{role}.{k}"] = v.detach().cpu().clone()
    for k, v in state.aux.items():  # began's k
        snap[f"aux.{k}"] = v.detach().cpu().clone()
    for name, opt in state.optimizers.items():
        for i, st in enumerate(opt.state.values()):
            for k, v in st.items():
                snap[f"{name}.opt{i}.{k}"] = torch.as_tensor(v).detach().cpu().clone()
    return snap


def _replay_vs_eager(tag, make, chunks, k, deterministic=False, n_eager=4):
    """The same state from the same seed run as eager steps ``n_eager`` times
    and through ``graph_steps`` (the warm-up call, the capture and its
    replay, a replay with new batches), each followed by one eager step.
    ``chunks`` is a tensor of (dispatches, k, ...) batches, or a tuple of
    them (images and labels), one a step argument.
    Where the eager runs agree bit for bit on a tensor the replay must too.
    Elsewhere the replay is one more run of the same nondeterministic
    arithmetic (cuDNN's weight gradients use atomics, and Adam turns their
    rounding into steps of up to lr, which 3K steps amplify): by module, its
    difference from the nearest eager run must stay within the largest
    difference between two eager runs. ``deterministic`` holds cuDNN to its
    deterministic algorithms for all the runs, where every tensor must then
    agree bit for bit. Returns the largest differences by module,
    (replay-nearest eager, eager-eager)."""
    import itertools

    import torch

    from tpugan_torch.train.loop import graph_steps

    chunks = (chunks,) if torch.is_tensor(chunks) else tuple(chunks)
    n_chunks = len(chunks[0])
    shipped = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        snaps = []
        for _ in range(n_eager):
            state, step = make()
            for c in range(n_chunks):
                for j in range(k):
                    state, _ = step(state, *(x[c][j] for x in chunks))
            state, _ = step(state, *(x[0][0] for x in chunks))
            torch.cuda.synchronize()
            snaps.append(_snapshot(state))
        state, step = make()
        fused = graph_steps(step, k)
        for c in range(n_chunks):
            state, out = fused(state, *(x[c] for x in chunks))
        state, _ = step(state, *(x[0][0] for x in chunks))
        torch.cuda.synchronize()
        replay = _snapshot(state)
    finally:
        torch.backends.cudnn.deterministic = shipped
    if (fused.calls, fused.replays) != (n_chunks, n_chunks - 1):
        raise AssertionError(f"{tag} {fused.calls} calls, {fused.replays} replays")
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError(f"{tag} non-finite outputs of the last replay")
    a = snaps[0]
    if not (torch.equal(replay["draws"], a["draws"]) and int(replay["step"]) == int(a["step"])):
        raise AssertionError(f"{tag} the generator's state or the step count after the replays "
                             f"differ from the eager runs'")
    pairs = list(itertools.combinations(range(n_eager), 2))
    rep, eag, exact, total = {}, {}, 0, 0
    for name, want in a.items():
        if name in ("draws", "step"):
            continue
        total += 1
        if not want.dtype.is_floating_point:
            if not all(torch.equal(s[name], want) for s in [replay, *snaps]):
                raise AssertionError(f"{tag} {name}: the replay or an eager run differs")
            exact += 1
            continue
        to_eager = [float((replay[name] - s[name]).abs().max()) for s in snaps]
        spread = max(float((snaps[i][name] - snaps[j][name]).abs().max()) for i, j in pairs)
        if spread == 0.0 and max(to_eager) != 0.0:
            raise AssertionError(f"{tag} {name}: the eager runs agree bit for bit, the replay "
                                 f"differs by {max(to_eager):.3e}")
        exact += max(to_eager) == 0.0
        role = name.split(".")[0]
        rep[role] = [max(r, t) for r, t in zip(rep.get(role, [0.0] * n_eager), to_eager)]
        eag[role] = max(eag.get(role, 0.0), spread)
    worst = {role: (min(rep[role]), eag[role]) for role in rep}
    if deterministic and exact != total:
        raise AssertionError(f"{tag} with deterministic cuDNN only {exact} of {total} tensors "
                             f"agree bit for bit: {worst}")
    for role, (near, spread) in worst.items():
        if near > spread:
            raise AssertionError(f"{tag} {role}: the replay differs from the nearest of "
                                 f"{n_eager} eager runs by {near:.3e}, two eager runs by at "
                                 f"most {spread:.3e}")
    mode = "deterministic cuDNN" if deterministic else "shipped settings"
    log(f"{tag} replay against {n_eager} eager runs ({mode}, K={k}, {n_chunks} dispatches and "
        f"one eager step after): generator state and step count equal; {exact} of {total} "
        "tensors bit for bit; largest differences by module, replay-nearest eager vs "
        "eager-eager: " + ", ".join(f"{r} {x:.3e} vs {y:.3e}" for r, (x, y) in worst.items()))
    return worst


def _fused_times(tag, smi, make, chunk, k, images_per_step, unit="step", n_replays=4):
    """Eager steps against replays of the same K steps from a CUDA graph, on
    one state: host-clock ms a step (synchronized), images/s, the capture's
    and instantiation's host seconds, max_memory_allocated around the
    capture (its peak reset just before), and one replay under
    torch.profiler: its device kernels, device time and busy share (the
    device time over the host time of the profiled replay, profiler
    included). ``chunk`` is a tensor of k batches, or a tuple of them
    (images and labels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpugan_torch.train.loop import graph_steps

    chunk = (chunk,) if torch.is_tensor(chunk) else tuple(chunk)
    state, step = make()
    for j in range(3):
        state, out = step(state, *(x[j] for x in chunk))
    torch.cuda.synchronize()
    n_eager = 2 * k
    t0 = time.perf_counter()
    for j in range(n_eager):
        state, out = step(state, *(x[j % k] for x in chunk))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / n_eager * 1e3
    fused = graph_steps(step, k)
    state, out = fused(state, *chunk)  # the eager warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, out = fused(state, *chunk)  # the capture, then a replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_replays):
        state, out = fused(state, *chunk)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / (n_replays * k) * 1e3
    if not all(bool(torch.isfinite(out[n]).all()) for n in out):
        raise AssertionError(f"{tag} non-finite outputs of a replay")
    # The profiler drops events in some runs, and a trace that drops some
    # can misreport the rest: bgan's once held 6,176 of 6,186 kernels and
    # half their device time. So a trace counts once another holds as many
    # kernels within 5% of its device time, and no trace held more; up to
    # six traces, else the device time is not measured.
    traces, kernels, prof_ms = [], [], None
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, out = fused(state, *chunk)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) * 1e3
        got = device_kernels(prof)
        traces.append((len(got), sum(e.time_range.elapsed_us() for e in got) / 1e3, t, got))
        most = max(n for n, *_ in traces)
        full = [x for x in traces if x[0] == most]
        pair = [a for i, a in enumerate(full) for b in full[i + 1:]
                if abs(a[1] - b[1]) <= 0.05 * max(a[1], b[1])]
        if pair:
            _, _, prof_ms, kernels = pair[0]
            break
    log(f"{tag} profiled replays: (kernels, device ms) "
        f"{[(n, round(ms, 3)) for n, ms, *_ in traces]}")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    r = {"eager_ms": eager_ms, "graph_ms": graph_ms, "capture_s": fused.capture_s,
         "instantiate_s": fused.instantiate_s, "first_s": first_s,
         "memory_before": fused.memory_before, "memory_after": fused.memory_after,
         "replay_kernels": [e.name for e in kernels],
         "device_ms": busy_ms / k if kernels else None,
         "busy": busy_ms / prof_ms if kernels else None}
    log(f"{tag} capture of {k} {unit}s: {fused.capture_s:.3f} s of host time, instantiation "
        f"{fused.instantiate_s:.3f} s (capture, instantiation and the first replay {first_s:.3f} "
        f"s); max_memory_allocated {fused.memory_before / 2**20:.1f} -> "
        f"{fused.memory_after / 2**20:.1f} MiB around the capture")
    log(f"{tag} one replay under torch.profiler: {len(kernels)} device kernels "
        f"({len(kernels) / k:.0f} a {unit}), {fmt_ms(r['device_ms'], 0)} ms of device time a "
        f"{unit}, in {fmt_ms(prof_ms, 0)} ms of host time: device busy "
        + (f"{r['busy']:.1%}" if kernels else "not measured"))
    log(f"{tag} on {torch.cuda.get_device_name(0)} ({smi}): eager {eager_ms:.3f} ms a {unit}, "
        f"{images_per_step * 1e3 / eager_ms:.1f} images/s (mean of {n_eager} after 3 warm-up); "
        f"graph {graph_ms:.3f} ms a {unit}, {images_per_step * 1e3 / graph_ms:.1f} images/s "
        f"(mean of {n_replays} replays of {k} {unit}s; host clock, synchronized)")
    return r


def _run_main(mod, argv, out_dir):
    """``mod.main(argv)`` with its output under ``out_dir``; the wall time
    and the port's kernel launches and graph replays it made."""
    import torch

    from tpugan_torch.train import loop

    _reset_port_launches()
    loop.reset_graph_counts()
    t0 = time.perf_counter()
    mod.main(argv + ["--output_dir", out_dir, "--metrics_jsonl",
                     os.path.join(out_dir, "metrics.jsonl")])
    torch.cuda.synchronize()
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 run with TF32 left on")
    return time.perf_counter() - t0, _port_launches(), loop.graph_replays


def _u8_chunks(shape, seed=0):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape,
                                                                 dtype=np.uint8)).cuda()


def phase_dcgan_fused(smi):
    """``dcgan.main`` at 64px with 60 steps a dispatch, replay against eager
    at K = 60, and the graphed step beside the eager one."""
    import torch

    from tpugan_torch.models import dcgan

    tag = "[dcgan fused]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dcgan_fused_")
    k, epochs = DCGAN_K, DCGAN_FUSED_EPOCHS
    n = epochs * DCGAN_EPOCH_BATCHES
    wall, launches, replays = _run_main(dcgan, [
        "--synthetic_data", "--n_epochs", str(epochs), "--max_batches",
        str(DCGAN_EPOCH_BATCHES), "--img_size", "64", "--sample_interval", str(k),
        "--log_interval", "30", "--steps_per_dispatch", str(k)], out_dir)
    log(f"{tag} main() with --steps_per_dispatch {k} took {wall:.1f} s (64px, batch 64: data, "
        f"modules, {epochs} epochs of {DCGAN_EPOCH_BATCHES} steps: a dispatch each, the first "
        f"eager, then the capture, and a tail of {DCGAN_EPOCH_BATCHES - k} eager steps; "
        f"samples); graph replays {replays}, the port's kernel launches {launches}, expected "
        f"none")
    if replays != epochs - 1:
        raise AssertionError(f"{tag} {replays} graph replays, expected {epochs - 1}")
    if any(launches.values()):
        raise AssertionError(f"{tag} launched the port's kernels: {launches}")
    _check_mnist_run(tag, out_dir, os.path.join(out_dir, "metrics.jsonl"), n, k, 64, 64)

    cfg = dcgan.Config(img_size=64, synthetic_data=True)
    dev = torch.device("cuda")

    def make():
        state = dcgan.create_state(cfg, dcgan.build(cfg, dev), dev)
        return state, dcgan.make_step(cfg, state)

    chunks = _u8_chunks((3, k, cfg.batch_size, 64, 64, 1))
    worst = {mode: _replay_vs_eager(tag, make, chunks, k, mode == "deterministic",
                                    2 if mode == "deterministic" else 4)
             for mode in ("deterministic", "shipped")}
    times = _fused_times(tag, smi, make, chunks[0], k, cfg.batch_size)
    return {"replay_vs_eager": worst, **times}


def _critic_fused(tag, smi, mod, epochs, k, interval, tail=0):
    """``mod.main`` of the critic family at its reference configuration
    unfused (one epoch of ``k`` units' batches and ``tail`` more) and with
    ``k`` schedule units a dispatch (``epochs`` such epochs, a dispatch each
    and ``tail`` batches unfused);
    the same rows' steps and keys, finite, and the PNGs both ways; then
    replay against eager and the graphed unit beside the eager one. Returns
    the fused run's launches, its replays and the times."""
    import json

    import torch

    from tpugan_torch.models._critic_family import make_schedule_unit

    runs = {}
    per_epoch = k * mod.Config.n_critic + tail
    for fused_k, n_epochs in ((1, 1), (k, epochs)):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_{fused_k}_")
        batches = n_epochs * per_epoch
        wall, launches, replays = _run_main(mod, [
            "--synthetic_data", "--n_epochs", str(n_epochs), "--max_batches", str(per_epoch),
            "--sample_interval", str(interval), "--log_interval", "50",
            "--steps_per_dispatch", str(fused_k)], out_dir)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["step"] for r in rows] != list(range(batches)):
            raise AssertionError(f"{tag} metric rows for steps {[r['step'] for r in rows]}")
        for row in rows:
            if not all(math.isfinite(v) for v in row.values()):
                raise AssertionError(f"{tag} non-finite losses at batch {row['step']}: {row}")
        imgdir = os.path.join(out_dir, "images")
        pngs = sorted(os.listdir(imgdir), key=lambda p: int(p.split(".")[0]))
        for name in pngs:
            with open(os.path.join(imgdir, name), "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"{tag} {name} is not a PNG")
        runs[fused_k] = (rows, pngs, launches, replays)
        log(f"{tag} main() --steps_per_dispatch {fused_k}, {n_epochs} epochs of {per_epoch} "
            f"batches: {wall:.1f} s; "
            f"graph replays {replays}; the port's kernel launches {launches}; losses finite in "
            f"{len(rows)} rows (last G row {[r for r in rows if 'g_loss' in r][-1]}); wrote "
            f"{pngs}")
    rows1, png1 = runs[1][:2]
    rows_k, png_k = runs[k][:2]
    keys = lambda rows: [(r["step"], sorted(r)) for r in rows]
    if keys(rows_k)[:len(rows1)] != keys(rows1) or not set(png1) <= set(png_k):
        raise AssertionError(f"{tag} the fused run's rows or PNGs differ from the unfused run's")
    if runs[k][3] != epochs - 1:
        raise AssertionError(f"{tag} {runs[k][3]} graph replays, expected {epochs - 1}")

    cfg = mod.Config(synthetic_data=True)
    dev = torch.device("cuda")

    def make():
        state = mod.create_state(cfg, mod.build(cfg, dev), dev)
        return state, make_schedule_unit(cfg, *mod.make_steps(cfg, state))

    chunks = _u8_chunks((3, k, cfg.n_critic, cfg.batch_size, 28, 28, 1))
    worst = _replay_vs_eager(tag, make, chunks, k)
    times = _fused_times(tag, smi, make, chunks[0], k, cfg.n_critic * cfg.batch_size,
                         unit="unit")
    return {"launches": runs[k][2], "launches_unfused": runs[1][2], "replays": runs[k][3],
            "replay_vs_eager": worst, **times}


def phase_wgan_gp_fused(smi):
    """WGAN-GP with 10 schedule units a dispatch over 100 batches: the GP
    pair inside the captured unit, its replayed launches counted as captured
    calls times replays and held against the kernels torch.profiler sees in
    a replay."""
    from tpugan_torch.models import wgan_gp

    tag = "[wgan_gp fused]"
    r = _critic_fused(tag, smi, wgan_gp, WGAN_FUSED_EPOCHS, WGAN_K, WGAN_SAMPLE_INTERVAL)
    n_batches = WGAN_FUSED_EPOCHS * WGAN_K * wgan_gp.Config.n_critic
    device = {}
    for d in ("fwd", "bwd"):
        calls, captured = r["launches"][f"gp_{d}"], r["launches"][f"gp_{d}_captured"]
        device[d] = calls - captured + captured * r["replays"]
    log(f"{tag} GP wrapper calls {r['launches']['gp_fwd']}/{r['launches']['gp_bwd']} (fwd/bwd), "
        f"{r['launches']['gp_fwd_captured']}/{r['launches']['gp_bwd_captured']} of them captured, "
        f"{r['replays']} replay: {device['fwd']}/{device['bwd']} launches on the device, "
        f"expected {n_batches} each way (one per critic step)")
    if device != {"fwd": n_batches, "bwd": n_batches}:
        raise AssertionError(f"{tag} GP launches on the device {device}")
    # The device kernels a replay holds: four forward and two backward
    # gp_gemm launches per critic step. A replay of 10 units launches about
    # 11,000 kernels in 3 ms, and the profiler drops some of them in some
    # runs, so the count is held on a graph of one unit, profiled up to five
    # times until a trace holds them all (none may hold more).
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpugan_torch.models._critic_family import make_schedule_unit
    from tpugan_torch.train.loop import graph_steps

    got10 = sum("gp_gemm<" in name for name in r["replay_kernels"])
    log(f"{tag} gp_gemm kernels in the profiled replay of {WGAN_K} units: {got10} of "
        f"{6 * WGAN_K * 5} (a short count is the profiler's dropped events)")
    cfg = wgan_gp.Config(synthetic_data=True)
    dev = torch.device("cuda")
    state = wgan_gp.create_state(cfg, wgan_gp.build(cfg, dev), dev)
    one = graph_steps(make_schedule_unit(cfg, *wgan_gp.make_steps(cfg, state)), 1)
    imgs = _u8_chunks((1, cfg.n_critic, cfg.batch_size, 28, 28, 1))
    for _ in range(2):
        state, _ = one(state, imgs)
    torch.cuda.synchronize()
    want, counts = 6 * cfg.n_critic, []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = one(state, imgs)
            torch.cuda.synchronize()
        counts.append(sum("gp_gemm<" in e.name for e in device_kernels(prof)))
        if counts[-1] == want:
            break
    log(f"{tag} gp_gemm kernels in a profiled replay of one unit: {counts} (tries), expected "
        f"{want}")
    if want not in counts or max(counts) > want:
        raise AssertionError(f"{tag} gp_gemm kernels in a replay of one unit: {counts}, "
                             f"expected {want}")
    r["device_launches"] = device
    return r


def phase_wgan_fused(smi):
    """wgan at its reference configuration, unfused and with 10 schedule
    units a dispatch (150 batches: three dispatches); it launches none of
    the port's kernels."""
    from tpugan_torch.models import wgan

    tag = "[wgan fused]"
    r = _critic_fused(tag, smi, wgan, WGAN_PLAIN_FUSED_EPOCHS, WGAN_K, WGAN_SAMPLE_INTERVAL)
    for launches in (r["launches"], r["launches_unfused"]):
        if any(launches.values()):
            raise AssertionError(f"{tag} launched the port's kernels: {launches}")
    return r


def _recipe_pngs(mod, cfg, out_dir, n_batches, epochs):
    """The PNGs a run_training trainer's main writes, and their grid size:
    the step's first 25 images 5 a row (gan, sgan and the rest of templates
    A/B); aae's 10x10 sheet of decoded codes; n_classes^2 images of
    the class grid, n_classes a row (cgan, acgan; infogan in its three
    folders); the last logged batch at each epoch's end, sqrt(batch) a row
    (dragan)."""
    cell = cfg.img_size + 2
    imgdir = os.path.join(out_dir, "images")
    if mod.NAME == "dragan":
        n_row = int(math.sqrt(cfg.batch_size))
        return ([os.path.join(imgdir, f"{e}.png") for e in range(epochs)],
                (n_row * cell + 2, -(-cfg.batch_size // n_row) * cell + 2))
    steps = range(0, n_batches, RECIPE_SAMPLE_INTERVAL)
    if mod.NAME in ("gan", "sgan", "bgan", "softmax_gan", "relativistic_gan", "ebgan", "began"):
        return [os.path.join(imgdir, f"{i}.png") for i in steps], (5 * cell + 2, 5 * cell + 2)
    if mod.NAME == "aae":
        return [os.path.join(imgdir, f"{i}.png") for i in steps], (10 * cell + 2, 10 * cell + 2)
    dirs = mod.SAMPLE_DIRS if mod.NAME == "infogan" else ("",)
    n_row = cfg.n_classes
    return ([os.path.join(imgdir, d, f"{i}.png") for d in dirs for i in steps],
            (n_row * cell + 2, n_row * cell + 2))


def _recipe_fused(tag, smi, mod):
    """``mod.main`` of a run_training trainer at its reference configuration
    unfused (one epoch of ``RECIPE_EPOCH_BATCHES``) and with ``RECIPE_K``
    steps a dispatch (two such epochs, a dispatch and a tail each): finite
    losses at every row, the same rows' steps and keys, every PNG by name
    and grid size, no launch of the port's kernels, one graph replay. Then
    replay against eager from the same seed with cuDNN held deterministic
    (bit for bit on every tensor), and the graphed step beside the eager
    one, with the batches' labels."""
    import numpy as np
    import torch

    cfg = mod.Config(synthetic_data=True)
    keys = {}
    for k, epochs in ((1, 1), (RECIPE_K, 2)):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_{k}_")
        n = epochs * RECIPE_EPOCH_BATCHES
        wall, launches, replays = _run_main(mod, [
            "--synthetic_data", "--n_epochs", str(epochs), "--max_batches",
            str(RECIPE_EPOCH_BATCHES), "--sample_interval", str(RECIPE_SAMPLE_INTERVAL),
            "--log_interval", "10", "--steps_per_dispatch", str(k)], out_dir)
        rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n)
        pngs, grid_wh = _recipe_pngs(mod, cfg, out_dir, n, epochs)
        _check_grids(tag, pngs, grid_wh)
        found = sorted(os.path.join(r, f) for r, _, files in os.walk(os.path.join(out_dir, "images"))
                       for f in files)
        log(f"{tag} main() --steps_per_dispatch {k}, {epochs} epoch(s) of {RECIPE_EPOCH_BATCHES} "
            f"batches ({cfg.img_size}px, batch {cfg.batch_size}): {wall:.1f} s; graph replays "
            f"{replays}; the port's kernel launches {launches}, expected none; losses finite in "
            f"{len(rows)} rows (last {rows[-1]}); {len(pngs)} PNGs, "
            f"{grid_wh[0]}x{grid_wh[1]}: {[os.path.relpath(p, out_dir) for p in pngs]}")
        if any(launches.values()):
            raise AssertionError(f"{tag} launched the port's kernels: {launches}")
        if replays != (epochs - 1 if k > 1 else 0):
            raise AssertionError(f"{tag} {replays} graph replays, expected {epochs - 1}")
        if found != sorted(pngs):
            raise AssertionError(f"{tag} wrote {found}, expected {sorted(pngs)}")
        keys[k] = [(r["step"], sorted(r)) for r in rows]
    if keys[RECIPE_K][:len(keys[1])] != keys[1]:
        raise AssertionError(f"{tag} the fused run's rows differ from the unfused run's")

    dev = torch.device("cuda")

    def make():
        state = mod.create_state(cfg, mod.build(cfg, dev), dev)
        return state, mod.make_step(cfg, state)

    b, size = cfg.batch_size, cfg.img_size
    imgs = _u8_chunks((3, RECIPE_K, b, size, size, 1))
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, 10, (3, RECIPE_K, b), dtype=np.int32)).to(dev)
    # With cuDNN held deterministic the eager runs agree bit for bit, and so
    # must the replay, on every tensor. The shipped settings' comparison is
    # one draw of a chaotic spread for the convolutional trainers (cuDNN's
    # atomics through 61 Adam steps): sgan's discriminator once lay 6.5e-2
    # from the nearest of four eager runs that lay at most 3.5e-2 apart.
    worst = _replay_vs_eager(tag, make, (imgs, labels), RECIPE_K, deterministic=True,
                             n_eager=2)
    times = _fused_times(tag, smi, make, (imgs[0], labels[0]), RECIPE_K, b)
    return {"replay_vs_eager": worst, **times}


def phase_critic_rest_fused(smi):
    """gan and dragan through ``run_training``, wgan_div through
    ``run_critic_family`` (K = 10 units, epochs with a tail of 3 batches),
    each unfused and fused; none launches a kernel of the port."""
    from tpugan_torch.models import dragan, gan, wgan_div

    out = {mod.NAME: _recipe_fused(f"[{mod.NAME} fused]", smi, mod) for mod in (gan, dragan)}
    tag = "[wgan_div fused]"
    r = _critic_fused(tag, smi, wgan_div, 2, WDIV_K, WGAN_SAMPLE_INTERVAL, tail=WDIV_TAIL)
    for launches in (r["launches"], r["launches_unfused"]):
        if any(launches.values()):
            raise AssertionError(f"{tag} launched the port's kernels: {launches}")
    out["wgan_div"] = r
    return out


def phase_conditional_fused(smi):
    """cgan, acgan, sgan and infogan through ``run_training``, each unfused
    and fused; none launches a kernel of the port."""
    from tpugan_torch.models import acgan, cgan, infogan, sgan

    return {mod.NAME: _recipe_fused(f"[{mod.NAME} fused]", smi, mod)
            for mod in (cgan, acgan, sgan, infogan)}


def phase_template_rest_fused(smi):
    """bgan, softmax_gan, relativistic_gan, ebgan, began and aae through
    ``run_training``, each unfused and fused; none launches a kernel of the
    port. began's replay must carry its k as the eager runs do: ``aux.k``
    is one of the tensors the replay is held to."""
    from tpugan_torch.models import aae, began, bgan, ebgan, relativistic_gan, softmax_gan

    out = {}
    for mod in (bgan, softmax_gan, relativistic_gan, ebgan, began, aae):
        t0 = time.perf_counter()
        out[mod.NAME] = _recipe_fused(f"[{mod.NAME} fused]", smi, mod)
        log(f"[{mod.NAME} fused] phase {time.perf_counter() - t0:.1f} s")
    near, spread = out["began"]["replay_vs_eager"]["aux"]
    log(f"[began fused] k after the replays against the eager runs': {near:.3e} "
        f"(eager-eager {spread:.3e})")
    return out


def phase_cluster_gan_slice(smi):
    """``cluster_gan.main`` at its reference configuration, eager, in both
    ``--wass_flag`` branches for two epochs of ``CLUSTER_BATCHES``: finite
    losses at every row, the three sheets an epoch by name and grid size,
    no launch of the port's kernels; then the steady-state schedule unit
    (one full_step and n_critic - 1 d_steps), its ms a step and busy
    share."""
    import torch

    from tpugan_torch.models import cluster_gan

    dev = torch.device("cuda")
    out = {}
    for wass in (False, True):
        tag = f"[cluster_gan slice{' wass' if wass else ''}]"
        cfg = cluster_gan.Config(synthetic_data=True, wass_flag=wass)
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_cluster_gan_")
        argv = ["--synthetic_data", "--n_epochs", "2", "--max_batches", str(CLUSTER_BATCHES)]
        wall, launches, _ = _run_main(cluster_gan, argv + (["--wass_flag"] if wass else []),
                                      out_dir)
        rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), 2 * CLUSTER_BATCHES)
        cell = cfg.img_size + 2
        sheets = {"cycle_reg": (5 * cell + 2, 5 * cell + 2), "gen": (5 * cell + 2, 5 * cell + 2),
                  "gen_classes": (10 * cell + 2, 10 * cell + 2)}
        imgdir = os.path.join(out_dir, "images")
        for name, wh in sheets.items():
            _check_grids(tag, [os.path.join(imgdir, "%s_%06i.png" % (name, e)) for e in range(2)],
                         wh)
        if len(os.listdir(imgdir)) != 2 * len(sheets):
            raise AssertionError(f"{tag} wrote {sorted(os.listdir(imgdir))}")
        if any(launches.values()):
            raise AssertionError(f"{tag} launched the port's kernels: {launches}")
        log(f"{tag} main() 2 epochs of {CLUSTER_BATCHES} batches ({cfg.img_size}px, batch "
            f"{cfg.batch_size}, n_critic {cfg.n_critic}): {wall:.1f} s; the port's kernel "
            f"launches {launches}, expected none; losses finite in {len(rows)} rows (last "
            f"{rows[-1]}); 6 sheets {sorted(os.listdir(imgdir))}")
        state = cluster_gan.create_state(cfg, cluster_gan.build(cfg, dev), dev)
        full_step, d_step = cluster_gan.make_steps(cfg, state)
        imgs = _u8_chunks((cfg.batch_size, cfg.img_size, cfg.img_size, 1))

        def unit():
            full_step(state, imgs)
            for _ in range(cfg.n_critic - 1):
                d_step(state, imgs)

        r = _step_report(tag, smi, unit, 5, "unit", cfg.batch_size * cfg.n_critic)
        r["ms_a_step"] = r["ms"] / cfg.n_critic
        log(f"{tag} {r['ms_a_step']:.3f} ms a step ({cfg.n_critic} steps a unit); device busy "
            + (f"{r['busy']:.1%}" if r["busy"] is not None else "not measured"))
        out["wass" if wass else "bce"] = r
    return out


def _in_capture_check(tag):
    """The IN pair launched inside a captured CUDA graph at a plane split over
    a cluster of 4 CTAs each way, (1, 64, 128, 128): the replay equals the
    launches outside the graph bit for bit, and the captured counters count
    the captured calls."""
    import torch

    from tpugan_torch.ops import instance_norm as tin

    shape = (1, 64, 128, 128)
    planes, hw = shape[0] * shape[1], shape[2] * shape[3]
    clusters = (tin.plan(planes, hw, "fwd").group, tin.plan(planes, hw, "bwd").group)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen)
    want = (*tin.in_act_fwd(x, EPS, 0.2), )
    want += (tin.in_act_bwd(g, x, want[1], want[2], 0.2),)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tin.in_act_fwd(x, EPS, 0.2)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = (tin.fwd_captured, tin.bwd_captured)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, mean, rstd = tin.in_act_fwd(x, EPS, 0.2)
        dx = tin.in_act_bwd(g, x, mean, rstd, 0.2)
    captured = (tin.fwd_captured - before[0], tin.bwd_captured - before[1])
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((y, mean, rstd, dx), want))
    log(f"{tag} IN pair captured at {shape} (clusters of {clusters[0]} CTAs forward, "
        f"{clusters[1]} backward) and replayed: bit for bit with the launches outside the "
        f"graph: {same}; captured calls counted {captured}")
    if not same or captured != (1, 1) or min(clusters) < 2:
        raise AssertionError(f"{tag} IN pair under capture: same {same}, captured {captured}, "
                             f"clusters {clusters}")


def phase_im2im_in():
    """The IN pair against its plain version at every (shape, slope) site of
    the five im2im paths, their steps' and their samplers', forward and
    backward, by path; a capture of the pair inside a CUDA graph at a
    clustered shape; then the times at each site of one step of each path
    (dualgan: a d_step and a g_step), with their sums."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)
    worst, done = _paths_parity(IM2IM_PATHS, gen)
    log(f"[im2im in parity] {len(done)} sites of the five paths pass, each repeating bit for "
        f"bit: max |dy|, |ddx| by path " + ", ".join(
            f"{p} {w['fwd']:.3g}, {w['bwd']:.3g}" for p, w in worst.items())
        + f" (y tol {Y_ATOL:g}, dx tol {DX_RTOL:g} of max|dx|)")
    _in_capture_check("[im2im in parity]")
    times = {path: _in_times(f"[im2im in time] {path}", timed_sites(path), [], gen)
             for path in IM2IM_PATHS}
    return worst, times


def _paths_parity(paths, gen):
    """``_parity_case`` once at every (shape, slope) site of every unit of
    ``paths``; the largest |dy| and |ddx| by path, and the sites done."""
    worst, done = {}, {}
    for path in paths:
        w = {"fwd": 0.0, "bwd": 0.0}
        for unit in IM2IM_IN[path]:
            for site in im2im_sites(path, unit):
                if site not in done:
                    done[site] = _parity_case(*site, 0.0, gen)
                w = {k: max(w[k], e) for k, e in zip(("fwd", "bwd"), done[site])}
        worst[path] = w
    return worst, done


def _step_report(tag, smi, step_once, n_timed, what, images, n_prof=3, traces=3):
    """Steady state of ``step_once`` (a step, or a unit): host-clock ms over
    ``n_timed`` after 3 warm-up, synchronized; then ``n_prof`` under
    torch.profiler, the most complete of ``traces`` traces: device time,
    device kernels and the busy share, and the IN pair's device time.
    Returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        step_once()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    kernels, prof_ms = [], None
    for _ in range(traces):  # keep the most complete trace (device_ms)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step_once()
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) * 1e3
        got = device_kernels(prof)
        if len(got) > len(kernels):
            kernels, prof_ms = got, t
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    in_ms = sum(e.time_range.elapsed_us() for e in kernels
                if "in_act_fwd_" in e.name or "in_act_bwd_" in e.name) / 1e3
    r = {"ms": ms, "device_ms": busy_ms / n_prof if kernels else None,
         "kernels": len(kernels) / n_prof, "busy": busy_ms / prof_ms if kernels else None,
         "in_device_ms": in_ms / n_prof if kernels else None}
    log(f"{tag} steady state on {torch.cuda.get_device_name(0)} ({smi}): {ms:.3f} ms a {what}, "
        f"{images * 1e3 / ms:.1f} images/s (mean of {n_timed} after 3 warm-up; host clock, "
        f"synchronized); profiled {n_prof}: {r['kernels']:.0f} device kernels and "
        f"{fmt_ms(r['device_ms'], 0)} ms of device time a {what}, the IN pair "
        f"{fmt_ms(r['in_device_ms'], 0)} ms of it; device busy "
        + (f"{r['busy']:.1%}" if kernels else "not measured"))
    return r


def _im2im_main(tag, mod, n_batches, interval, grid_wh, in_units):
    """``mod.main`` at its reference configuration for ``n_batches`` with
    samples every ``interval`` and a checkpoint: finite losses at every row,
    each PNG by name and grid size, each checkpoint by the reference's name,
    finite; the IN launches against ``in_units`` (unit -> count in the run).
    Returns the launches."""
    import torch

    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_")
    wall, launches, _ = _run_main(mod, [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(n_batches),
        "--sample_interval", str(interval), "--checkpoint_interval", "1", "--log_interval", "1"],
        out_dir)
    log("")
    rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n_batches)
    # stargan writes images/ and saved_models/ without the dataset's folder
    # (stargan.py:297-300); it samples on its g_step batches only.
    sub = "" if mod.NAME == "stargan" else mod.Config.dataset_name
    every = max(interval, mod.Config.n_critic) if mod.NAME == "stargan" else interval
    pngs = [os.path.join(out_dir, "images", sub, f"{i}.png") for i in range(0, n_batches, every)]
    _check_grids(tag, pngs, grid_wh)
    ckpts = [os.path.join(out_dir, "saved_models", sub, f"{m}_0.pth") for m in mod.MODULES]
    fresh = mod.build(mod.Config(), torch.device("cpu"))
    for name, path in zip(mod.MODULES, ckpts):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if not all(torch.isfinite(v).all() for v in sd.values()):
            raise AssertionError(f"{tag} non-finite weights in {os.path.basename(path)}")
        fresh[name].load_state_dict(sd)
    want = {d: sum(n * im2im_per_unit(mod.NAME, unit, d) for unit, n in in_units.items())
            for d in ("fwd", "bwd")}
    got = {"fwd": launches["in_fwd"], "bwd": launches["in_bwd"]}
    log(f"{tag} main() took {wall:.1f} s ({n_batches} batches: {in_units}); losses finite in "
        f"{len(rows)} rows (last {rows[-1]}); wrote {[os.path.basename(p) for p in pngs]} "
        f"({grid_wh[0]}x{grid_wh[1]}) and {[os.path.basename(p) for p in ckpts]}, each reloaded "
        f"into a new module; IN launches "
        f"{got}, expected {want}")
    if got != want or any(launches[k] for k in launches if not k.startswith("in_")):
        raise AssertionError(f"{tag} launches {launches}, expected IN {want} and no other")
    return got


def _grid_wh(n, h, w, nrow):
    return nrow * (w + 2) + 2, -(-n // nrow) * (h + 2) + 2


def phase_im2im_slices(smi):
    """pix2pix (256px, batch 1), discogan (64px, batch 64) and dualgan
    (128px, batch 8, n_critic 5) through their mains, eager, then each
    step's steady state."""
    import numpy as np
    import torch

    from tpugan_torch.models import discogan, dualgan, pix2pix

    dev = torch.device("cuda")
    out = {}
    for mod, grid in ((pix2pix, _grid_wh(10, 3 * 256, 256, 5)),
                      (discogan, _grid_wh(64, 64, 64, 8)),
                      (dualgan, _grid_wh(32, 2 * 128, 128, 8))):
        tag = f"[{mod.NAME} slice]"
        n, interval = IM2IM_SLICE[mod.NAME]
        samples = len(range(0, n, interval))
        if mod is dualgan:
            units = {"d_step": n, "g_step": len(range(0, n, dualgan.Config.n_critic)),
                     "sample": samples}
        else:
            units = {"step": n, "sample": samples}
        launches = _im2im_main(tag, mod, n, interval, grid, units)
        cfg = mod.Config(synthetic_data=True)
        size = getattr(cfg, "img_size", None) or cfg.img_height
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, size, size, 3),
                                              dtype=np.uint8)).to(dev) for _ in range(2))
        state = mod.create_state(cfg, mod.build(cfg, dev), dev)
        if mod is dualgan:
            d_step, g_step = dualgan.make_steps(cfg, state)

            def unit():  # one schedule unit: n_critic critic steps, one generator step
                for i in range(cfg.n_critic):
                    d_step(state, a, b)
                    if i == 0:
                        g_step(state, a, b)

            r = _step_report(tag, smi, unit, 4, f"unit of {cfg.n_critic} batches",
                             cfg.n_critic * cfg.batch_size)
        else:
            step = mod.make_step(cfg, state)
            r = _step_report(tag, smi, lambda: step(state, a, b), 20, "step", cfg.batch_size)
        out[mod.NAME] = {"launches": launches, **r}
    return out


def _inpainting_fused(tag, smi, mod):
    """``mod.main`` at its reference configuration unfused (one epoch of
    ``INPAINT_EPOCH_BATCHES``) and with ``INPAINT_K`` steps a CUDA graph (two
    such epochs): finite losses, the same rows' steps and keys, the PNGs by
    name, the graph's replays, and the IN pair's launches on the device
    (wrapper calls not captured, plus captured calls times replays), 6 each
    way a step. Then replay against eager from the same seed with cuDNN held
    deterministic (bit for bit on every tensor), and the graphed step beside
    the eager one."""
    import torch

    cfg = mod.Config(synthetic_data=True)
    k, per_step = INPAINT_K, im2im_per_unit(mod.NAME, "step", "fwd")
    keys, device = {}, {"fwd": 0, "bwd": 0}
    calls = {"fwd": 0, "bwd": 0, "fwd_captured": 0, "bwd_captured": 0, "replays": 0}
    for fused_k, epochs in ((1, 1), (k, 2)):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_{fused_k}_")
        n = epochs * INPAINT_EPOCH_BATCHES
        wall, launches, replays = _run_main(mod, [
            "--synthetic_data", "--n_epochs", str(epochs), "--max_batches",
            str(INPAINT_EPOCH_BATCHES), "--sample_interval", str(INPAINT_SAMPLE_INTERVAL),
            "--log_interval", "5", "--steps_per_dispatch", str(fused_k)], out_dir)
        rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n)
        pngs = sorted(os.listdir(os.path.join(out_dir, "images")), key=lambda p: int(p[:-4]))
        want_pngs = [f"{i}.png" for i in range(0, n, INPAINT_SAMPLE_INTERVAL)]
        for d in ("fwd", "bwd"):
            cap = launches[f"in_{d}_captured"]
            device[d] += launches[f"in_{d}"] - cap + cap * replays
            calls[d] += launches[f"in_{d}"]
            calls[f"{d}_captured"] += cap
        calls["replays"] += replays
        log(f"{tag} main() --steps_per_dispatch {fused_k}, {epochs} epoch(s) of "
            f"{INPAINT_EPOCH_BATCHES} batches ({cfg.img_size}px, batch {cfg.batch_size}): "
            f"{wall:.1f} s; graph replays {replays}; IN wrapper calls {launches['in_fwd']}/"
            f"{launches['in_bwd']}, {launches['in_fwd_captured']}/{launches['in_bwd_captured']} "
            f"of them captured; losses finite in {len(rows)} rows (last {rows[-1]}); wrote {pngs}")
        if pngs != want_pngs:
            raise AssertionError(f"{tag} wrote {pngs}, expected {want_pngs}")
        if replays != (epochs * (INPAINT_EPOCH_BATCHES // k) - 1 if fused_k > 1 else 0):
            raise AssertionError(f"{tag} {replays} graph replays")
        keys[fused_k] = [(r["step"], sorted(r)) for r in rows]
    want = 3 * INPAINT_EPOCH_BATCHES * per_step
    log(f"{tag} IN launches on the device over both runs {device}, expected {want} each way "
        f"({per_step} a step)")
    if device != {"fwd": want, "bwd": want} or not calls["fwd_captured"]:
        raise AssertionError(f"{tag} IN launches on the device {device}, calls {calls}")
    if keys[k][:len(keys[1])] != keys[1]:
        raise AssertionError(f"{tag} the fused run's rows differ from the unfused run's")

    dev = torch.device("cuda")

    def make():
        state = mod.create_state(cfg, mod.build(cfg, dev), dev)
        return state, mod.make_step(cfg, state)

    imgs = _u8_chunks((3, k, cfg.batch_size, cfg.img_size, cfg.img_size, 3))
    worst = _replay_vs_eager(tag, make, imgs, k, deterministic=True, n_eager=2)
    times = _fused_times(tag, smi, make, imgs[0], k, cfg.batch_size)
    return {"device_launches": device, "calls": calls, "replay_vs_eager": worst, **times}


def phase_inpainting_fused(smi):
    """context_encoder and ccgan through ``run_training``, unfused and fused:
    the IN pair inside the captured graph."""
    from tpugan_torch.models import ccgan, context_encoder

    return {mod.NAME: _inpainting_fused(f"[{mod.NAME} fused]", smi, mod)
            for mod in (context_encoder, ccgan)}


# --- PR 11: stargan, unit, pixelda, cogan ------------------------------------------


def _times_of(path: str, k: str) -> str:
    n = sum(im2im_per_unit(path, u, k) for u in IN_TIMED_UNITS[path])
    return f"one {path} step ({'+'.join(IN_TIMED_UNITS[path])}), {n} launches"


def phase_new_in():
    """The IN pair against its plain version at every (shape, slope) site of
    the stargan, unit and pixelda paths, their steps' and samplers', both
    directions, each repeating bit for bit (``[<path> in parity]``); then the
    times at each site of one step of each path, with their sums
    (``[<path> in time]``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst, times = {}, {}
    for path in NEW_IN_PATHS:
        t0 = time.perf_counter()
        w, done = _paths_parity((path,), gen)
        worst[path] = w[path]
        log(f"[{path} in parity] {len(done)} sites pass, each repeating bit for bit: max |dy| "
            f"{w[path]['fwd']:.3g}, |ddx| {w[path]['bwd']:.3g} (y tol {Y_ATOL:g}, dx tol "
            f"{DX_RTOL:g} of max|dx|); {time.perf_counter() - t0:.1f} s")
        times[path] = _in_times(f"[{path} in time]", timed_sites(path), [], gen)
    return worst, times


# stargan 5 batches (one g_step at batch 0, n_critic 5) and unit 6, each
# sampling at batch 0 (unit also at 5) with a checkpoint.
NEW_SLICE = {"stargan": (5, 5), "unit": (6, 5)}


def phase_new_slices(smi):
    """stargan (128px, batch 16, 6 residual blocks, n_critic 5) and unit
    (256px, batch 1, dim 64) through their mains at the reference
    configuration, eager (``_im2im_main``: finite losses, the sheets, the
    checkpoints reloaded, the exact IN launches); then the steady state of
    stargan's d_step and g_step apart and of unit's step, with the peak
    memory of each (``[stargan slice]``, ``[unit slice]``)."""
    import numpy as np
    import torch

    from tpugan_torch.models import stargan, unit

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    for mod, grid in ((stargan, _grid_wh(1, 10 * 128, 6 * 128, 1)),
                      (unit, _grid_wh(20, 256, 256, 5))):
        t0 = time.perf_counter()
        tag = f"[{mod.NAME} slice]"
        n, interval = NEW_SLICE[mod.NAME]
        cfg = mod.Config(synthetic_data=True)
        if mod is stargan:
            units = {"d_step": n, "g_step": len(range(0, n, cfg.n_critic)),
                     "sample": len(range(0, n, max(cfg.n_critic, interval)))}
        else:
            units = {"step": n, "sample": len(range(0, n, interval))}
        launches = _im2im_main(tag, mod, n, interval, grid, units)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = mod.create_state(cfg, mod.build(cfg, dev), dev)
        size = cfg.img_height
        imgs = torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, size, size, 3),
                                             dtype=np.uint8)).to(dev)
        if mod is stargan:
            labels = torch.from_numpy(rng.integers(0, 2, (cfg.batch_size, 5)).astype(
                np.float32)).to(dev)
            d_step, g_step = stargan.make_steps(cfg, state)
            _, d_out = d_step(state, imgs, labels)
            c = d_out["sampled_c"]
            rd = _step_report(f"{tag} d_step", smi, lambda: d_step(state, imgs, labels, c), 10,
                              "d_step", cfg.batch_size)
            rg = _step_report(f"{tag} g_step", smi, lambda: g_step(state, imgs, labels, c), 5,
                              "g_step", cfg.batch_size)
            r = {"d_step": rd, "g_step": rg,
                 **{k: rd[k] + rg[k] for k in ("ms", "device_ms", "in_device_ms", "kernels")
                    if rd[k] is not None and rg[k] is not None}}
            r.setdefault("device_ms", None)
            r.setdefault("in_device_ms", None)
        else:
            b = torch.from_numpy(rng.integers(0, 256, imgs.shape, dtype=np.uint8)).to(dev)
            step = unit.make_step(cfg, state)
            r = _step_report(tag, smi, lambda: step(state, imgs, b), 10, "step", cfg.batch_size)
        torch.cuda.synchronize()
        r["max_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
        log(f"{tag} max_memory_allocated over the steady-state steps "
            f"{r['max_memory_mib']:.1f} MiB; phase {time.perf_counter() - t0:.1f} s")
        out[mod.NAME] = {"launches": launches, **r}
        del state
        torch.cuda.empty_cache()
    return out


def phase_tracked_in():
    """stargan's tracked IN, ``InstanceNorm(256, affine=True,
    track_running_stats=True)``, on the card at the generator's (16, 256,
    32, 32) with a random affine and random buffers: a train-mode forward
    launches the IN forward once and nothing else, and its y and running
    buffers agree with a plain PyTorch computation of torch's update; a
    frozen forward leaves the buffers bit for bit; an eval-mode forward
    launches nothing and agrees with the plain formula (``[stargan tracked
    in]``). Tolerances: y 1e-5 absolute (unit-scale planes, offset 0.5, scale
    2); buffers 1e-6 absolute plus 1e-5 relative."""
    import torch

    from tpugan_torch.nn.layers import InstanceNorm, batch_stats_frozen
    from tpugan_torch.ops import instance_norm as tin

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    c, shape, eps, m = 256, (16, 256, 32, 32), 1e-5, 0.1
    layer = InstanceNorm(c, affine=True, track_running_stats=True).to(dev)
    with torch.no_grad():
        layer.weight.copy_(1.0 + 0.3 * torch.randn(c, device=dev, generator=gen))
        layer.bias.copy_(0.3 * torch.randn(c, device=dev, generator=gen))
        layer.running_mean.copy_(0.2 * torch.randn(c, device=dev, generator=gen))
        layer.running_var.copy_(1.0 + 0.5 * torch.rand(c, device=dev, generator=gen))
    w, b = layer.weight.detach().view(1, -1, 1, 1), layer.bias.detach().view(1, -1, 1, 1)
    rm0, rv0 = layer.running_mean.clone(), layer.running_var.clone()
    x = torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5
    _reset_port_launches()
    with torch.no_grad():
        y = layer(x)
    torch.cuda.synchronize()
    train_launches = _port_launches()
    hw = shape[2] * shape[3]
    mean = x.mean(dim=(2, 3))
    var = ((x - mean[:, :, None, None]) ** 2).sum(dim=(2, 3)) / (hw - 1)
    rm_ref = (1 - m) * rm0 + m * mean.mean(dim=0)
    rv_ref = (1 - m) * rv0 + m * var.mean(dim=0)
    y_ref = tin.in_act_fwd_ref(x, eps, 1.0)[0] * w + b
    errs = {"y": float((y - y_ref).abs().max()),
            "running_mean": float(((layer.running_mean - rm_ref).abs()
                                   / (1e-6 + 1e-5 * rm_ref.abs())).max()),
            "running_var": float(((layer.running_var - rv_ref).abs()
                                  / (1e-6 + 1e-5 * rv_ref.abs())).max())}
    after = (layer.running_mean.clone(), layer.running_var.clone())
    with torch.no_grad(), batch_stats_frozen(layer):
        y_frozen = layer(x)
    frozen_same = (torch.equal(layer.running_mean, after[0])
                   and torch.equal(layer.running_var, after[1]) and torch.equal(y_frozen, y))
    layer.eval()
    _reset_port_launches()
    with torch.no_grad():
        y_eval = layer(x)
    torch.cuda.synchronize()
    eval_launches = _port_launches()
    want = (x - after[0].view(1, -1, 1, 1)) / torch.sqrt(after[1].view(1, -1, 1, 1) + eps) * w + b
    errs["eval y"] = float((y_eval - want).abs().max())
    log(f"[stargan tracked in] train forward at {shape}: IN launches {train_launches['in_fwd']} "
        f"forward, {train_launches['in_bwd']} backward; |y - plain| {errs['y']:.3g}; buffers "
        f"against the plain update, |err| / (1e-6 + 1e-5 |want|): mean {errs['running_mean']:.3g}, "
        f"var {errs['running_var']:.3g}; frozen forward leaves them bit for bit: {frozen_same}; "
        f"eval forward: launches {eval_launches['in_fwd']}, |y - plain| {errs['eval y']:.3g}")
    others = {k: v for k, v in train_launches.items() if k != "in_fwd" and v}
    if train_launches["in_fwd"] != 1 or others or any(eval_launches.values()):
        raise AssertionError(f"[stargan tracked in] launches: train {train_launches}, eval "
                             f"{eval_launches}")
    if (errs["y"] > Y_ATOL or errs["eval y"] > Y_ATOL or errs["running_mean"] > 1.0
            or errs["running_var"] > 1.0 or not frozen_same):
        raise AssertionError(f"[stargan tracked in] {errs}, frozen {frozen_same}")
    return errs


# pixelda and cogan fused: unfused one epoch of 25 batches, then K = 10 steps
# a CUDA graph over two (two dispatches and a tail of 5 each).
TWO_DOMAIN_K, TWO_DOMAIN_EPOCH_BATCHES, TWO_DOMAIN_SAMPLE_INTERVAL = 10, 25, 10


def _two_domain_fused(tag, smi, mod):
    """``mod.main`` at its reference configuration over the MNIST/MNIST-M
    ``ZipLoader``, unfused (one epoch of ``TWO_DOMAIN_EPOCH_BATCHES``) and with
    ``TWO_DOMAIN_K`` steps a CUDA graph (two such epochs): finite losses, the
    same rows' steps and keys, each PNG by name and grid size, the graph's
    replays, and the IN pair's launches on the device (wrapper calls not
    captured, plus captured calls times replays): pixelda's 18 forward and
    15 backward a step, cogan's none. Then replay against eager from the
    same seed with cuDNN held deterministic (bit for bit on every tensor),
    and the graphed step beside the eager one."""
    import numpy as np
    import torch

    cfg = mod.Config(synthetic_data=True)
    k, epoch_n = TWO_DOMAIN_K, TWO_DOMAIN_EPOCH_BATCHES
    units = ("step", "telemetry") if mod.NAME == "pixelda" else ()
    per_step = {d: sum(im2im_per_unit(mod.NAME, u, d) for u in units) for d in ("fwd", "bwd")}
    n_img = min(5, cfg.batch_size)  # pixelda: five of A over their translations over five of B
    grid = (_grid_wh(n_img, 3 * cfg.img_size, cfg.img_size,
                     min(n_img, int(math.sqrt(cfg.batch_size)))) if mod.NAME == "pixelda"
            else _grid_wh(2 * cfg.batch_size, cfg.img_size, cfg.img_size, 8))
    keys, device = {}, {"fwd": 0, "bwd": 0}
    calls = {"fwd": 0, "bwd": 0, "fwd_captured": 0, "bwd_captured": 0, "replays": 0}
    for fused_k, epochs in ((1, 1), (k, 2)):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_{fused_k}_")
        n = epochs * epoch_n
        wall, launches, replays = _run_main(mod, [
            "--synthetic_data", "--n_epochs", str(epochs), "--max_batches", str(epoch_n),
            "--sample_interval", str(TWO_DOMAIN_SAMPLE_INTERVAL), "--log_interval", "5",
            "--steps_per_dispatch", str(fused_k)], out_dir)
        rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n)
        pngs = sorted(os.listdir(os.path.join(out_dir, "images")), key=lambda p: int(p[:-4]))
        want_pngs = [f"{i}.png" for i in range(0, n, TWO_DOMAIN_SAMPLE_INTERVAL)]
        if pngs != want_pngs:
            raise AssertionError(f"{tag} wrote {pngs}, expected {want_pngs}")
        _check_grids(tag, [os.path.join(out_dir, "images", p) for p in pngs], grid)
        for d in ("fwd", "bwd"):
            cap = launches[f"in_{d}_captured"]
            device[d] += launches[f"in_{d}"] - cap + cap * replays
            calls[d] += launches[f"in_{d}"]
            calls[f"{d}_captured"] += cap
        calls["replays"] += replays
        others = {n_: v for n_, v in launches.items() if not n_.startswith("in_") and v}
        log(f"{tag} main() --steps_per_dispatch {fused_k}, {epochs} epoch(s) of {epoch_n} batches "
            f"({cfg.img_size}px, batch {cfg.batch_size}): {wall:.1f} s; graph replays {replays}; "
            f"IN wrapper calls {launches['in_fwd']}/{launches['in_bwd']}, "
            f"{launches['in_fwd_captured']}/{launches['in_bwd_captured']} of them captured; "
            f"losses finite in {len(rows)} rows (last {rows[-1]}); wrote {pngs} "
            f"({grid[0]}x{grid[1]})")
        if others:
            raise AssertionError(f"{tag} launched other kernels of the port: {others}")
        if replays != (epochs * (epoch_n // k) - 1 if fused_k > 1 else 0):
            raise AssertionError(f"{tag} {replays} graph replays")
        keys[fused_k] = [(r["step"], sorted(r)) for r in rows]
    want = {d: 3 * epoch_n * per_step[d] for d in ("fwd", "bwd")}
    log(f"{tag} IN launches on the device over both runs {device}, expected {want} ({per_step} "
        f"a step)")
    if device != want or (per_step["fwd"] and not calls["fwd_captured"]):
        raise AssertionError(f"{tag} IN launches on the device {device}, calls {calls}")
    if keys[k][:len(keys[1])] != keys[1]:
        raise AssertionError(f"{tag} the fused run's rows differ from the unfused run's")

    dev = torch.device("cuda")

    def make():
        state = mod.create_state(cfg, mod.build(cfg, dev), dev)
        return state, mod.make_step(cfg, state)

    b, size = cfg.batch_size, cfg.img_size
    rng = np.random.default_rng(1)
    labels = lambda: torch.from_numpy(rng.integers(0, 10, (3, k, b), dtype=np.int32)).to(dev)
    chunks = (_u8_chunks((3, k, b, size, size, 3), 0), labels(),
              _u8_chunks((3, k, b, size, size, 3), 1), labels())
    worst = _replay_vs_eager(tag, make, chunks, k, deterministic=True, n_eager=2)
    times = _fused_times(tag, smi, make, tuple(c[0] for c in chunks), k, b)
    return {"device_launches": device, "calls": calls, "replay_vs_eager": worst, **times}


def phase_two_domain_fused(smi):
    """pixelda and cogan through ``run_training`` over a ``ZipLoader``,
    unfused and fused: pixelda's IN pair inside the captured graph
    (``[pixelda fused]``, ``[cogan fused]``)."""
    from tpugan_torch.models import cogan, pixelda

    out = {}
    for mod in (pixelda, cogan):
        t0 = time.perf_counter()
        out[mod.NAME] = _two_domain_fused(f"[{mod.NAME} fused]", smi, mod)
        log(f"[{mod.NAME} fused] phase {time.perf_counter() - t0:.1f} s")
    return out


# bicyclegan, srgan and esrgan through their mains: batches a run, and the
# sample and checkpoint intervals (esrgan: warm-up batches too).
BICYCLE_BATCHES, SR_BATCHES = 6, 6


def _steady_memory(tag, report):
    """``report()`` (``_step_report``s) between a reset of the peak memory
    and a read of ``max_memory_allocated``; the reports, with the peak in
    MiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = report()
    torch.cuda.synchronize()
    out["max_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log(f"{tag} max_memory_allocated over the steady-state steps {out['max_memory_mib']:.1f} MiB")
    return out


def _slice_main(tag, mod, argv, pngs, grid_wh, ckpts):
    """``mod.main(argv)``: finite losses at every row, each of ``pngs``
    (paths under images/) a PNG of ``grid_wh``, each of ``ckpts`` (paths
    under saved_models/, the module name first) reloaded into a new module,
    no launch of the port's kernels. Returns the run's output folder."""
    import torch

    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{mod.NAME}_")
    n = int(argv[argv.index("--max_batches") + 1])
    wall, launches, _ = _run_main(mod, argv, out_dir)
    log("")
    rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n)
    _check_grids(tag, [os.path.join(out_dir, "images", p) for p in pngs], grid_wh)
    fresh = mod.build(mod.Config(), torch.device("cpu"))
    for path in ckpts:
        sd = torch.load(os.path.join(out_dir, "saved_models", path), map_location="cpu",
                        weights_only=True)
        if not all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point()):
            raise AssertionError(f"{tag} non-finite weights in {path}")
        fresh[os.path.basename(path).rsplit("_", 1)[0]].load_state_dict(sd)
    log(f"{tag} main() {n} batches in {wall:.1f} s; losses finite in {len(rows)} rows (last "
        f"{rows[-1]}); wrote {pngs} ({grid_wh[0]}x{grid_wh[1]}) and {ckpts}, each reloaded into "
        f"a new module; the port's kernel launches {launches}, expected none")
    if any(launches.values()):
        raise AssertionError(f"{tag} launched the port's kernels: {launches}")
    return out_dir


def phase_bicyclegan_slice(smi):
    """``bicyclegan.main`` at the reference configuration (128px, batch 8,
    latent 8) for ``BICYCLE_BATCHES`` batches with a sample sheet at batch 0
    and the four checkpoints, eager; then the steady-state step, its device
    time, busy share, kernels and peak memory (``[bicyclegan slice]``)."""
    import numpy as np
    import torch

    from tpugan_torch.models import bicyclegan

    tag = "[bicyclegan slice]"
    cfg = bicyclegan.Config(synthetic_data=True)
    n = BICYCLE_BATCHES
    sheet = ((cfg.latent_dim + 1) * cfg.img_width + 4, 8 * cfg.img_height + 4)
    _slice_main(tag, bicyclegan, [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(n), "--sample_interval",
        str(n), "--checkpoint_interval", "1"], [f"{cfg.dataset_name}/0.png"], sheet,
        [f"{cfg.dataset_name}/{m}_0.pth" for m in bicyclegan.MODULES])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, cfg.img_height,
                                                   cfg.img_width, 3), dtype=np.uint8)).to(dev)
            for _ in range(2))

    def report():
        state = bicyclegan.create_state(cfg, bicyclegan.build(cfg, dev), dev)
        step = bicyclegan.make_step(cfg, state)
        return _step_report(tag, smi, lambda: step(state, a, b), 10, "step", cfg.batch_size,
                            n_prof=2, traces=1)

    return _steady_memory(tag, report)


def _sr_batch(cfg):
    import numpy as np
    import torch

    shape = (cfg.batch_size, cfg.hr_height, cfg.hr_height, cfg.channels)
    return torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)).cuda()


def phase_srgan_slice(smi):
    """``srgan.main`` at the reference configuration (HR 256, batch 4, 16
    residual blocks, the He-random VGG19 features[:18]) for ``SR_BATCHES``
    batches with samples and checkpoints; then the steady-state step
    (``[srgan slice]``)."""
    import torch

    from tpugan_torch.models import srgan

    tag = "[srgan slice]"
    cfg = srgan.Config(synthetic_data=True)
    interval = SR_BATCHES - 1
    grid = (2 * (cfg.hr_height + 4), cfg.batch_size * (cfg.hr_height + 2) + 2)
    _slice_main(tag, srgan, [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(SR_BATCHES),
        "--sample_interval", str(interval), "--checkpoint_interval", "1"],
        [f"{i}.png" for i in range(0, SR_BATCHES, interval)], grid,
        [f"{m}_0.pth" for m in srgan.MODULES])
    dev = torch.device("cuda")
    imgs = _sr_batch(cfg)

    def report():
        state = srgan.create_state(cfg, srgan.build(cfg, dev), dev)
        step = srgan.make_step(cfg, state)
        return _step_report(tag, smi, lambda: step(state, imgs), 10, "step", cfg.batch_size,
                            n_prof=2, traces=1)

    return _steady_memory(tag, report)


def phase_esrgan_slice(smi):
    """``esrgan.main`` at the reference configuration (HR 256, batch 4, 23
    RRDB blocks, the He-random VGG19 features[:35]) for ``SR_BATCHES``
    batches, the first 2 warm-up batches, previews every 2 and a checkpoint
    every 4 batches; then the warm-up and the full step apart, the full
    step's FLOPs (``torch.utils.flop_counter``), its share of the FP32 peak
    and the peak memory (``[esrgan slice]``). Returns the numbers and the
    generator checkpoint."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tpugan_torch.models import esrgan

    tag = "[esrgan slice]"
    cfg = esrgan.Config(synthetic_data=True)
    warm, interval, every = 2, 2, 4
    grid = (2 * cfg.hr_height + 4, cfg.batch_size * (cfg.hr_height + 2) + 2)
    out_dir = _slice_main(tag, esrgan, [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", str(SR_BATCHES),
        "--warmup_batches", str(warm), "--sample_interval", str(interval),
        "--checkpoint_interval", str(every)],
        [f"training/{i}.png" for i in range(warm, SR_BATCHES, interval)], grid,
        [f"{m}_0.pth" for m in esrgan.MODULES])
    dev = torch.device("cuda")
    imgs = _sr_batch(cfg)
    state = esrgan.create_state(cfg, esrgan.build(cfg, dev), dev)
    warmup_step, full_step = esrgan.make_steps(cfg, state)

    def report():
        rw = _step_report(f"{tag} warmup_step", smi, lambda: warmup_step(state, imgs), 5,
                          "warmup_step", cfg.batch_size, n_prof=1, traces=1)
        rf = _step_report(f"{tag} full_step", smi, lambda: full_step(state, imgs), 5,
                          "full_step", cfg.batch_size, n_prof=1, traces=1)
        return {"warmup_step": rw, "full_step": rf}

    out = _steady_memory(tag, report)
    with FlopCounterMode(display=False) as counter:
        full_step(state, imgs)
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    peak = peaks(torch.cuda.get_device_name(0))[0]
    rf = out["full_step"]
    rf["tflop"] = flops / 1e12
    rf["peak_share"] = flops / peak / (rf["ms"] / 1e3)
    dev_share = flops / peak / (rf["device_ms"] / 1e3) if rf["device_ms"] else None
    log(f"{tag} full_step: {flops / 1e12:.4f} TFLOP (convolutions and matmuls, forward and "
        f"backward; torch.utils.flop_counter), {flops / peak * 1e3:.3f} ms at the FP32 peak: "
        f"{rf['peak_share']:.1%} of it over the step's {rf['ms']:.3f} ms"
        + (f", {dev_share:.1%} over its device time" if dev_share else ""))
    out["generator_ckpt"] = os.path.join(out_dir, "saved_models", "generator_0.pth")
    return out


def phase_test_on_image(ckpt):
    """``python -m tpugan_torch test_on_image`` on a 64x64 RGB PNG written by
    the port's ``encode_png``, with the esrgan slice's generator checkpoint:
    the output is 260x260 (4x, and save_image's 2 px border), and its pixels
    are the loaded generator's forward, denormalized and quantized as
    torchvision's ``save_image`` does (``[test_on_image]``)."""
    import numpy as np
    import torch

    from tpugan_torch.io.images import decode_png, encode_png
    from tpugan_torch.models import esrgan
    from tpugan_torch.nn.sr import ESRGANGenerator
    from tpugan_torch.nn.vgg import imagenet_denormalize, imagenet_normalize

    tag = "[test_on_image]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_test_on_image_")
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    path = os.path.join(out_dir, "face.png")
    with open(path, "wb") as f:
        f.write(encode_png(img))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpugan_torch", "test_on_image", "--image_path",
                           path, "--checkpoint_model", ckpt, "--output_dir", out_dir],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(os.path.join(out_dir, "images", "outputs", "sr-face.png"), "rb") as f:
        got = decode_png(f.read())
    G = ESRGANGenerator(num_res_blocks=esrgan.TestOnImageConfig.residual_blocks)
    G.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    G = G.cuda().eval()
    with torch.no_grad():
        x = torch.from_numpy(img).cuda().permute(2, 0, 1)[None].float() / 255.0
        sr = imagenet_denormalize(G(imagenet_normalize(x)))[0].permute(1, 2, 0).cpu().numpy()
    want = np.zeros((260, 260, 3), np.uint8)
    want[2:-2, 2:-2] = (np.clip(sr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)) if got.shape == want.shape else None
    log(f"{tag} the CLI took {wall:.1f} s (a process of its own); wrote sr-face.png "
        f"{got.shape[1]}x{got.shape[0]}; against the in-process forward of the loaded generator, "
        f"quantized: max |diff| "
        + (f"{int(diff.max())}, {float((diff == 0).mean()):.4%} of the values equal"
           if diff is not None else "not comparable"))
    if diff is None or diff.max() > 1:
        raise AssertionError(f"{tag} output {got.shape} does not hold to the generator's forward")
    return {"max_diff": int(diff.max()), "equal": float((diff == 0).mean()), "cli_s": wall}


def _timed_phase(name, fn):
    """``fn()``, its host seconds logged."""
    t0 = time.perf_counter()
    out = fn()
    log(f"[phase seconds] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    smi = _timed_phase("device", phase_device)
    _timed_phase("build", phase_build)
    _timed_phase("launch cost", lambda: phase_launch_cost(smi))
    in_worst, in_time = _timed_phase("in parity and time", phase_parity)
    in_launches = _timed_phase("cyclegan slice", lambda: phase_slice(smi))
    gp_worst = _timed_phase("gp parity", phase_gp_parity)
    gp_time = _timed_phase("gp time", lambda: phase_gp_time(smi))
    gp_launches = _timed_phase("wgan_gp slice", lambda: phase_wgan_slice(smi))
    adain_worst = _timed_phase("adain parity", phase_adain_parity)
    adain_time = _timed_phase("adain time", lambda: phase_adain_time(smi))
    munit_in_worst, munit_in_time = _timed_phase("munit in", phase_munit_in)
    munit_launches = _timed_phase("munit slice", lambda: phase_munit_slice(smi))
    im2im_worst, im2im_time = _timed_phase("im2im in", phase_im2im_in)
    im2im = _timed_phase("im2im slices", lambda: phase_im2im_slices(smi))
    _timed_phase("dcgan slice", lambda: phase_dcgan_slice(smi))
    fused = {"dcgan 64px": _timed_phase("dcgan fused", lambda: phase_dcgan_fused(smi)),
             "wgan_gp": _timed_phase("wgan_gp fused", lambda: phase_wgan_gp_fused(smi)),
             "wgan": _timed_phase("wgan fused", lambda: phase_wgan_fused(smi))}
    gp_fused = fused["wgan_gp"]
    fused.update(_timed_phase("critic rest fused", lambda: phase_critic_rest_fused(smi)))
    fused.update(_timed_phase("conditional fused", lambda: phase_conditional_fused(smi)))
    inpainting = _timed_phase("inpainting fused", lambda: phase_inpainting_fused(smi))
    fused.update(inpainting)
    new_in_worst, new_in_time = _timed_phase("new in", phase_new_in)
    new_slices = _timed_phase("new slices", lambda: phase_new_slices(smi))
    _timed_phase("stargan tracked in", phase_tracked_in)
    two_domain = _timed_phase("two-domain fused", lambda: phase_two_domain_fused(smi))
    fused.update(two_domain)
    fused.update(_timed_phase("template rest fused", lambda: phase_template_rest_fused(smi)))
    _timed_phase("cluster_gan slice", lambda: phase_cluster_gan_slice(smi))
    _timed_phase("bicyclegan slice", lambda: phase_bicyclegan_slice(smi))
    _timed_phase("srgan slice", lambda: phase_srgan_slice(smi))
    esrgan_out = _timed_phase("esrgan slice", lambda: phase_esrgan_slice(smi))
    _timed_phase("test_on_image", lambda: phase_test_on_image(esrgan_out["generator_ckpt"]))
    bench_rec = _timed_phase("dcgan bench", phase_dcgan_bench)
    keep = ("eager_ms", "graph_ms", "device_ms", "busy", "capture_s", "instantiate_s",
            "memory_before", "memory_after", "replay_vs_eager")
    log("[fused summary] " + json.dumps({
        **{name: {key: r[key] for key in keep} for name, r in fused.items()},
        "bench_images_per_sec": bench_rec["value"]}))
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
        # The IN pair runs on eleven paths. Its launches and error cover them
        # all; its times are one CycleGAN step's, and by_path keeps each
        # path's own launches (on the device: captured calls count once a
        # replay), error and, where measured, times over one step of it.
        by_path = {
            path: {"launches": n, "max_abs_err": worst[k], **t[k], "times_of": times_of}
            for path, n, worst, t, times_of in (
                ("cyclegan", in_launches[k], in_worst, in_time,
                 f"one cyclegan step, {FWD_PER_STEP} launches"),
                ("munit", munit_launches[f"in_{k}"], munit_in_worst, munit_in_time,
                 f"one munit step, {MUNIT_IN_PER_STEP} launches"))
        }
        for path in ("pix2pix", "discogan", "dualgan"):
            by_path[path] = {"launches": im2im[path]["launches"][k],
                             "max_abs_err": im2im_worst[path][k],
                             "step_ms": im2im[path]["ms"],
                             "step_in_device_ms": im2im[path]["in_device_ms"]}
            by_path[path].update(im2im_time[path][k], times_of=_times_of(path, k))
        for path in ("stargan", "unit"):
            by_path[path] = {"launches": new_slices[path]["launches"][k],
                             "max_abs_err": new_in_worst[path][k],
                             "step_ms": new_slices[path]["ms"],
                             "step_in_device_ms": new_slices[path]["in_device_ms"],
                             **new_in_time[path][k], "times_of": _times_of(path, k)}
        for path, r in {**inpainting, "pixelda": two_domain["pixelda"]}.items():
            by_path[f"{path} cuda_graph"] = {
                "launches": r["device_launches"][k],
                "max_abs_err": {**im2im_worst, **new_in_worst}[path][k],
                "wrapper_calls": r["calls"][k], "captured": r["calls"][f"{k}_captured"],
                "replays": r["calls"]["replays"]}
            times = {**im2im_time, **new_in_time}[path][k]
            by_path[f"{path} cuda_graph"].update(times, times_of=_times_of(path, k))
        c = by_path["cyclegan"]
        kernels.append({
            "name": f"in_act_{k}", "route": "cuda", "source": in_src,
            "replaces": replaces[f"in_act_{k}"],
            "launches": sum(p["launches"] for p in by_path.values()),
            "max_abs_err": max(p["max_abs_err"] for p in by_path.values()), "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": "bytes",
            "library_ms": c["library_ms"], "device_ms": c["device_ms"],
            "times_of": c["times_of"], "by_path": by_path,
        })
    for k in ("fwd", "bwd"):
        # The GP pair runs on the WGAN-GP path unfused and inside the
        # replayed schedule unit: launches on the device, the replayed ones
        # counted as captured wrapper calls times replays.
        t = gp_time[k]
        fused_calls = gp_fused["launches"][f"gp_{k}"]
        captured = gp_fused["launches"][f"gp_{k}_captured"]
        by_path = {
            "wgan_gp": {"launches": gp_launches[k]},
            "wgan_gp cuda_graph": {"launches": gp_fused["device_launches"][k],
                                   "wrapper_calls": fused_calls, "captured": captured,
                                   "replays": gp_fused["replays"]},
        }
        kernels.append({
            "name": f"mlp_gp_{k}", "route": "cuda", "source": gp_src,
            "replaces": replaces[f"mlp_gp_{k}"],
            "launches": gp_launches[k] + gp_fused["device_launches"][k], "by_path": by_path,
            "max_abs_err": gp_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"],
            "graph_ms": t["graph_ms"],
            "cublas_products_device_ms": t["cublas_products_device_ms"],
        })
    for k in ("fwd", "bwd"):
        t = adain_time[k]
        kernels.append({
            "name": f"adain_{k}", "route": "cuda", "source": in_src,
            "replaces": replaces[f"adain_{k}"], "launches": munit_launches[f"adain_{k}"],
            "max_abs_err": adain_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "times_of": f"one munit step, {ADAIN_PER_STEP} launches",
        })
    log(f"[script seconds] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
