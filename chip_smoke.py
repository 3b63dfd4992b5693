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
7. AdaIN parity, time and launches: the AdaIN pair against its plain
   version on the card, forward and backward, at the MUNIT slice's shapes
   and at a ragged H*W, 1x1 planes, a large offset, w with zeros and
   negatives, and w and bias as column slices of a (B, 4C x 3) tensor, read in
   place, directly and through ``adain()`` with autograd (the bits of
   contiguous copies); both directions must repeat bit for bit. Then the
   kernels' times at the slice's two shapes beside the plain version, the
   bound and ``F.instance_norm`` (forward) or ``native_batch_norm_backward``
   (backward) on the (1, B*C, H, W) view, CUDA events and device time, and
   ``adain()`` forward and backward on the slices beside
   ``F.instance_norm``'s through autograd (``[adain time]``); then the
   device kernels of one call each way, which must be one, in float32 and
   bf16, on contiguous and strided w/bias (``[adain launches]``).
8. MUNIT IN parity and time: the instance-norm pair against its plain
   version at every (shape, slope) site of the MUNIT path, the step's and the
   sample grid's, down to the discriminator's 2x2 planes; then the times at
   each site and their sums over one MUNIT step.
9. MUNIT slice: ``tpugan_torch.models.munit.main`` at the reference
   configuration (128px, batch 1, dim 64, 3 residual blocks) for 6 steps
   with samples and checkpoints; checks finite losses, the sample sheets and
   checkpoints, and the exact AdaIN and IN launch counts; then the
   steady-state step time, the step's FLOPs and operations bound, the
   device's busy share, its kernels (those of autograd's SliceBackward0
   apart) and the step's largest device kernels (torch.profiler).
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
   replay against eager from the same seed, three dispatches of
   ``REPLAY_CHECK_K`` = 10 steps or units (bit for bit where the eager runs
   are, else ``replay_rule``: within the mean plus 50 standard deviations of
   the distances between 6 eager runs; DCGAN also with cuDNN held
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
22. ``--dtype bfloat16``: ``[in bf16 parity]``/``[in bf16 time]`` and
   ``[munit in bf16 time]``, the bf16 IN pair against its plain bf16
   version at every (shape, slope) site of the CycleGAN and MUNIT paths,
   ragged planes and a large offset, within one bf16 ulp plus the float32
   tolerances and bit-repeatable, then its times beside the plain version,
   ``F.instance_norm`` on bf16, the float32 kernels and the bound at 4 and 6
   bytes an element; ``[adain bf16 parity]``/``[adain bf16 time]`` likewise
   for AdaIN, with the strided w/bias of phase 7 and the library calls'
   device time; ``[cyclegan bf16 slice]`` and ``[munit bf16 slice]``, each
   main with ``--dtype bfloat16`` at its reference configuration for 4
   steps (exact bf16 launches, no float32 one, float32 checkpoints), the
   step in float32 and bf16 in turns, the bf16 step's largest kernels, and
   for CycleGAN cuDNN's kernels for the 256-to-128 conv at 128x128 in both
   dtypes; ``[dcgan bf16 fused]`` (main at K = 60, replay against eager in
   bf16 at K = 10 with the shipped settings, and the bench's bf16 line) and ``[wgan_gp
   bf16]`` (one float32 GP launch each way a critic step, the unit in both
   dtypes in turns); then
   ``[replay rule]``, the false-alarm bound of the script's shipped-settings
   replay checks, which must stay within 1%, and a ``[bf16 summary]`` line.
23. The observability flags, checkpoints and FID: ``[flags profile]``
   (``--profile_dir``: ``dcgan.main`` at 64px, batch 64, 4 steps a dispatch
   and ``--profile_steps 8``, and ``cyclegan.main`` at 256px, batch 1, fp32,
   4 steps and ``--profile_steps 1``: each trace one TensorBoard file that
   parses as JSON, holding exactly the ranges of dispatches 1 and 2 (DCGAN)
   or 1 (CycleGAN), the CycleGAN one naming the IN kernels); ``[flags ragged]``
   (``--ragged_last_batch`` with 4 steps a dispatch over the synthetic set's
   4,096 images at batch 60, the tail of 16 run eagerly after the last
   replay: ``wgan_gp.run``, the MLP critic at 784-512-256-1, the tail's
   critic step launching the GP pair at batch 16, one GP launch each way a
   critic step on the device, state and losses held to 6 eager runs by
   ``replay_rule``; ``dcgan.run`` at 64px with cuDNN deterministic, bit for
   bit 2 eager runs); ``[flags debug_numerics]`` (``cyclegan.main`` and
   ``munit.main`` at their reference configurations for 2 steps under
   anomaly mode with the IN and AdaIN kernels launched, then a CycleGAN step
   fed a NaN raising FloatingPointError); ``[checkpoint]`` (pix2pix's
   ``.pth`` files, a save failing midway leaving them whole, the ``--epoch``
   resume bit for bit); ``[fid]`` (``eval_fid`` on DCGAN, 2,048 samples at
   batch 256 through the InceptionV3 and VGG19 extractors, He-random: FID
   and images/s; the Inception forward on the card against its float64
   forward on the CPU on 4 images), then a ``[flags summary]`` line.
24. Data parallelism (``tpugan_torch/parallel``): ``[dp nccl]``,
   ``dcgan.main`` at 64px, batch 64, fp32, 15 steps at K = 5 (cuDNN held
   deterministic), without data parallelism and inside a one-rank NCCL group
   whose all-reduces and BatchNorm all-gathers the CUDA graph captures with
   the steps: two replays each, the losses (first step 1e-4 relative, every
   step 1e-2) and parameters (within how far two runs of Adam can drift,
   ``adam_envelope``) against the run without it, the running statistics'
   distance reported;
   then the graphed step both ways, images/s, and the device time of the
   replay's NCCL kernels. ``[dp gloo]``: two spawned ranks in a gloo group
   sharing the card, each running ``dcgan.main`` (64px, batch 64),
   ``wgan_gp.main`` (batch 64) and ``cyclegan.main`` (256px, batch 2, 9
   residual blocks, fp32, the replay buffer on the gathered fakes) for two
   batches, eager; the IN pair and the GP pair launched inside the
   data-parallel steps (exact counts), both ranks' states equal, and each
   held to one process on the card (losses 1e-3 relative, parameters within
   ``adam_envelope``); then a ``[dp summary]`` line.
25. DCGAN bench: ``tpugan_torch.bench`` (64px, batch 64, fp32, one CUDA graph
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
three of them inside replayed CUDA graphs, and under ``--profile_dir`` and
``--debug_numerics`` and on two data-parallel ranks, the GP pair, which runs
eager, inside the replayed WGAN-GP unit, on its ragged tail and on two
data-parallel ranks, and AdaIN, on MUNIT with and without
``--debug_numerics``, also by path; the bf16 forms of the IN pair, on the
bf16 CycleGAN and MUNIT paths, and of AdaIN),
``nvidia-smi``'s name and power limit, and ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances, kernel against the plain version, both fp32 on the card with
# sums in different orders. y: 1e-5 absolute on unit-scale planes; with an
# offset mu the inputs carry ulp(mu) of rounding, so 1e-5 * (1 + |mu|/std).
# dx: 1e-4 of the plane's largest |dx| (the backward subtracts two means).
Y_ATOL = 1e-5
DX_RTOL = 1e-4
SLOPES = (0.0, 0.2, 1.0)
EPS = 1e-5
# The bf16 forms against their plain bf16 version: both compute in float32
# and round each output to bf16 once, so where the two float32 results
# straddle a rounding boundary they differ by one bf16 ulp. The tolerance is
# one ulp at the larger magnitude (``bf16_ulp``) plus the float32 tolerances
# above. BF16_ULP is the ulp of 1 (8 significant bits).
BF16_ULP = 2.0 ** -7

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
# acgan, sgan, infogan, bgan, softmax_gan, relativistic_gan, ebgan, began,
# aae) unfused for one epoch of 15 batches, then with K = 10 steps a graph
# over two epochs of 15 (a dispatch and a tail of 5 each); wgan_div unfused
# for one epoch of 53 batches, then with K = 10 units (50 batches) a graph
# over two (a tail of 3 each). Short, so that the script keeps inside its
# time limit.
RECIPE_K, RECIPE_EPOCH_BATCHES, RECIPE_SAMPLE_INTERVAL = 10, 15, 5
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
# the sample interval (each samples at batch 0 and 2; dualgan's batch 0
# takes a g_step).
IM2IM_SLICE = {"pix2pix": (3, 2), "discogan": (3, 2), "dualgan": (3, 2)}
# The steady state of the im2im, stargan and unit slices (``_step_report``):
# steps timed (dualgan 2 units, stargan's d_step and unit's step half,
# stargan's g_step 3), steps profiled and the traces the fullest is kept from.
IM2IM_TIMED, IM2IM_PROFILED, IM2IM_TRACES = 10, 2, 2
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


def call_kernels(fn, calls: int, want=None, traces: int = 3) -> list:
    """The names of the device kernels of ``calls`` calls of ``fn``
    (torch.profiler, after one call of warm-up), from the fullest of up to
    ``traces`` traces, since the profiler drops events in some sessions; a
    trace of ``want`` kernels ends the search."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in device_kernels(prof)]
        if len(names) > len(best):
            best = names
        if len(best) == want:
            break
    return best


def _affine(name: str) -> bool:
    """Whether an ``instance_norm.cu`` kernel's name is its AdaIN instance:
    the last template argument, kAffine, is true."""
    return name.split("<")[1].split(">")[0].endswith("true")


def one_affine_kernel_a_call(names, calls: int, direction: str) -> bool:
    """Whether ``calls`` calls of an AdaIN wrapper in ``direction`` ("fwd"
    or "bwd") launched one kernel each, read off a torch.profiler trace of
    them (``call_kernels``): every traced kernel is the affine instance of
    ``instance_norm.cu``'s kernel in that direction, at least one and at
    most one a call. The profiler drops a few events in some sessions (the
    first three of each trace in one whole-script run), so fewer than
    ``calls`` may come back; a second kernel in a call (a cast, a copy)
    shows by its name, a second launch of the kernel by the count."""
    return 0 < len(names) <= calls and all(
        f"in_act_{direction}_" in n and _affine(n) for n in names)


def _kernel_mix(names, calls: int) -> str:
    """The kernels of ``calls`` calls by name (cut to 60 characters), a call's
    count of each."""
    counts = {}
    for name in names:
        counts[name[:60]] = counts.get(name[:60], 0) + 1
    return "; ".join(f"{n / calls:g} x {name}" for name, n in
                     sorted(counts.items(), key=lambda kv: -kv[1]))


def slice_backward_kernels(prof) -> int:
    """The device kernels of a torch.profiler run launched inside autograd's
    SliceBackward0 nodes: the fills and copies that route a slice's gradient
    into a gradient of the sliced tensor's shape, and the sums that add it to
    the other slices' (counted through the profiler's tree of CPU events)."""
    def below(e):
        return len(e.kernels) + sum(below(ch) for ch in e.cpu_children)

    return sum(below(e) for e in prof.events()
               if e.name == "autograd::engine::evaluate_function: SliceBackward0")


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
    args = (*ptrs, 1.0, c, c, plan_arg, tin.raw_stream(dev))
    # A plan of no planes: the C entry returns before any CUDA call.
    no_launch = (*ptrs, 1.0, c, c, ctypes.byref(_build.LaunchPlan(0, hw, 1, 0, 0, 32)),
                 args[-1])
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
        ("checks, one pass over 4 tensors", lambda: _build.check_tensors(
            "adain_bwd", dev, g, x, mean, rstd)),
        ("  and w's dtype, shape and row stride (per_plane_strides)",
         lambda: tin.per_plane_strides("adain_bwd", x, w, dev=dev)),
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


def _in_times(tag, step_sites, sample_sites, gen, dtype=None):
    """At each (shape, slope, launches) site, or (shape, slope, forward
    launches, backward launches) where a step differentiates only some of
    its calls: the IN pair's times beside the
    plain version's, the bound (8 bytes an element forward, 12 backward; 4
    and 6 in bf16) and
    the PyTorch call that computes the slope-1 function on the (1, B*C, H, W)
    view, ``F.instance_norm`` forward and ``native_batch_norm_backward``
    backward (CUDA events); then the device time per call of the kernels and
    of the library calls (``device_ms``). The library calls are first held to
    the plain slope-1 version. ``dtype`` bfloat16 times the bf16 forms on
    bf16 maps, and the float32 kernels on the same values widened
    (``fp32_ms``). Returns the sums over one step's sites."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import instance_norm as tin

    dtype = dtype or torch.float32
    bf16 = dtype is torch.bfloat16
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "library_device_ms")
    keys += ("fp32_ms",) if bf16 else ()
    per_step = {k: dict.fromkeys(keys, 0.0) for k in ("fwd", "bwd")}
    cols = " ".join(k.replace("_ms", "").replace("library", "lib") for k in keys)
    log(f"{tag} shape          slope launches/step | fwd {cols} | bwd {cols}")
    for i, (shape, slope, *n) in enumerate(step_sites + sample_sites):
        n = {"fwd": n[0], "bwd": n[-1]}
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        _, mean, rstd = tin.in_act_fwd_ref(x, EPS, slope)
        b, c, h, wd = shape
        x1, g1 = x.view(1, b * c, h, wd), g.view(1, b * c, h, wd)

        def lib_fwd():
            return F.instance_norm(x, eps=EPS)

        def lib_bwd():
            return torch.ops.aten.native_batch_norm_backward(
                g1, x1, None, None, None, mean, rstd, True, EPS, [True, False, False])[0]

        plain = (tin.in_act_fwd_ref(x, EPS, 1.0)[0], tin.in_act_bwd_ref(g, x, mean, rstd, 1.0))
        if bf16:  # a library call that does not take bf16 is not measured
            lib_fwd, lib_bwd = (_library_or_none(tag, f) for f in (lib_fwd, lib_bwd))
        lib_err = max([_rel_err(lib().reshape(r.shape).float(), r.float())
                       for lib, r in zip((lib_fwd, lib_bwd), plain) if lib] or [0.0])
        if lib_err > (2 * BF16_ULP if bf16 else DX_RTOL):
            raise AssertionError(f"the library calls differ from slope-1 IN at {shape}: "
                                 f"{lib_err:.3g}")
        reps = max(5, min(200, int(2e8 / x.numel())))
        fns = {"fwd": (lambda: tin.in_act_fwd(x, EPS, slope),
                       lambda: tin.in_act_fwd_ref(x, EPS, slope), lib_fwd),
               "bwd": (lambda: tin.in_act_bwd(g, x, mean, rstd, slope),
                       lambda: tin.in_act_bwd_ref(g, x, mean, rstd, slope), lib_bwd)}
        t = {}
        elem = x.element_size()
        for k, nbytes in (("fwd", 2 * elem * x.numel()), ("bwd", 3 * elem * x.numel())):
            kern, ref, lib = fns[k]
            t[k] = {"ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(ref, reps),
                    "bound_ms": bound_ms(0.0, nbytes)[0],
                    "library_ms": cuda_ms(lib, reps) if lib else None,
                    "device_ms": device_ms(kern, reps),
                    "library_device_ms": device_ms(lib, reps) if lib else None}
        if bf16:
            x32, g32 = x.float(), g.float()
            t["fwd"]["fp32_ms"] = cuda_ms(lambda: tin.in_act_fwd(x32, EPS, slope), reps)
            t["bwd"]["fp32_ms"] = cuda_ms(lambda: tin.in_act_bwd(g32, x32, mean, rstd, slope), reps)
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


def _out_error(got, want, tol):
    """(largest |got - want|, its share of the tolerance): ``tol``, plus one
    bf16 ulp at the larger magnitude where ``got`` is bf16."""
    import torch

    if got.dtype is torch.bfloat16:
        err, share, _ = _bf16_errors(got, want, tol)
        return err, share
    err = float((got - want).abs().max())
    return err, err / tol


def _adain_errors(got, want, offset, w):
    """Largest errors of (y, mean, rstd, dx, dw, db), kernel against plain,
    each one's share of its tolerance, and those past it: the tolerances of
    ``ADAIN_CASES``, plus one bf16 ulp at the larger magnitude on bf16
    outputs (the statistics stay float32)."""
    import torch

    y_k, mean_k, rstd_k, *grads_k = got
    y_r, mean_r, rstd_r, *grads_r = want
    errs = {"mean": float((mean_k - mean_r).abs().max()),
            "rstd": float(((rstd_k - rstd_r).abs() / rstd_r).max())}
    share = {"mean": errs["mean"] / (Y_ATOL * (1.0 + abs(offset))), "rstd": errs["rstd"] / Y_ATOL}
    outs = {"y": (y_k, y_r, Y_ATOL * (1.0 + abs(offset)) * max(1.0, float(w.float().abs().max())))}
    for name, a, b in zip(("dx", "dw", "db"), grads_k, grads_r):
        outs[name] = (a, b, DX_RTOL * float(b.float().abs().max()) + 1e-7)
    for k, (a, b, tol) in outs.items():
        errs[k], share[k] = _out_error(a, b, tol)
    bad = {k: (errs[k], share[k]) for k in errs if not share[k] <= 1.0}
    return errs, share, bad


def _adain_case(tag, shape, offset, w_kind, gen, dtype):
    """One ``ADAIN_CASES`` case in ``dtype``: both directions against the
    plain version, each repeating bit for bit, dw and dbias in w's dtype.
    Returns the errors and their shares of the tolerance."""
    import torch

    from tpugan_torch.ops import adain as ta

    x, w, bias, g = (t.to(dtype) for t in _adain_inputs(shape, offset, w_kind, gen))
    fwd, fwd_again = ta.adain_fwd(x, w, bias, EPS), ta.adain_fwd(x, w, bias, EPS)
    y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w, bias, EPS)
    bwd = ta.adain_bwd(g, x, w, mean_r, rstd_r)
    bwd_again = ta.adain_bwd(g, x, w, mean_r, rstd_r)
    bwd_r = ta.adain_bwd_ref(g, x, w, mean_r, rstd_r)
    torch.cuda.synchronize()
    for name, a, b in (("forward", fwd, fwd_again), ("backward", bwd, bwd_again)):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{tag} {name} at {shape} does not repeat bit for bit")
    if [t.dtype for t in (fwd[0], *bwd)] != [dtype] * 4:
        raise AssertionError(f"{tag} y, dx, dw, dbias dtypes {[t.dtype for t in (fwd[0], *bwd)]}")
    errs, share, bad = _adain_errors((*fwd, *bwd), (y_r, mean_r, rstd_r, *bwd_r), offset, w)
    if bad:
        raise AssertionError(f"{tag} disagrees at {shape} offset {offset} w {w_kind}: {bad} "
                             "(error, share of its tolerance)")
    log(f"{tag} {str(shape):18s} offset {offset:<5g} w {w_kind:6s} | "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " | share of tol "
        + " ".join(f"{k} {v:.2f}" for k, v in share.items()) + " | bit-repeatable")
    return errs, share


def _style_params(b, c, dtype, gen):
    """The style MLP's output as MUNIT's decoder takes it at C channels: (B,
    4C) a residual block, 3 blocks; entries about 0.5 +- 0.5."""
    import torch

    return (0.5 + 0.5 * torch.randn((b, 12 * c), device="cuda", generator=gen)).to(dtype)


def _adain_strided(tag, dtype, gen):
    """w and bias as column slices of a (B, 4C x 3) tensor of ``dtype``, as the
    AdaIN residual block takes them from the style MLP ([bias1, weight1,
    ...]; rows 12C apart), at the MUNIT step and sample shapes. Directly
    through ``adain_fwd``/``adain_bwd``: the bits of the same calls on
    contiguous copies (the kernels read the same values in place), the plain
    version within the tolerances of ``ADAIN_CASES``, bit-repeatable, dw and
    dbias contiguous (B, C) in w's dtype. Then through ``adain()`` with
    autograd, twice: y, dx and the (B, 4C x 3) tensor's gradient against the
    plain version, bit for bit between the two. Returns the errors and their
    shares of the tolerance, the largest of each."""
    import torch

    from tpugan_torch.ops import adain as ta

    out = {}
    for shape in (ADAIN_STEP_SHAPE, ADAIN_SAMPLE_SHAPE):
        b, c = shape[:2]
        x, _, _, g = (t.to(dtype) for t in _adain_inputs(shape, 0.0, "normal", gen))
        params = _style_params(b, c, dtype, gen)
        w_s, b_s = params[:, c:2 * c], params[:, :c]
        w_c, b_c = w_s.contiguous(), b_s.contiguous()
        if (w_s.stride(0), b_s.stride(0)) != (12 * c, 12 * c):
            raise AssertionError(f"{tag} the slices' row strides are {w_s.stride()}, "
                                 f"{b_s.stride()}")
        fwd = ta.adain_fwd(x, w_s, b_s, EPS)
        bwd = ta.adain_bwd(g, x, w_s, fwd[1], fwd[2])
        again = (*ta.adain_fwd(x, w_s, b_s, EPS), *ta.adain_bwd(g, x, w_s, fwd[1], fwd[2]))
        contiguous = (*ta.adain_fwd(x, w_c, b_c, EPS), *ta.adain_bwd(g, x, w_c, fwd[1], fwd[2]))
        y_r, mean_r, rstd_r = ta.adain_fwd_ref(x, w_c, b_c, EPS)
        bwd_r = ta.adain_bwd_ref(g, x, w_c, fwd[1], fwd[2])
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip((*fwd, *bwd), again)):
            raise AssertionError(f"{tag} strided w/bias at {shape} does not repeat bit for bit")
        if not all(torch.equal(u, v) for u, v in zip((*fwd, *bwd), contiguous)):
            raise AssertionError(f"{tag} strided w/bias at {shape} differ from contiguous copies")
        if [(t.dtype, t.is_contiguous(), tuple(t.shape)) for t in bwd[1:]] != [(dtype, True,
                                                                                 (b, c))] * 2:
            raise AssertionError(f"{tag} dw, dbias {[(t.dtype, t.stride()) for t in bwd[1:]]}")
        errs, share, bad = _adain_errors((*fwd, *bwd), (y_r, mean_r, rstd_r, *bwd_r), 0.0, w_c)
        if bad:
            raise AssertionError(f"{tag} strided w/bias at {shape} disagree: {bad} (error, share "
                                 "of its tolerance)")

        # Through the autograd Function, as the residual block calls it.
        params.requires_grad_()
        xg = x.clone().requires_grad_()
        runs = []
        for _ in range(2):
            y = ta.adain(xg, params[:, c:2 * c], params[:, :c], EPS)
            runs.append((y.detach(), *torch.autograd.grad(y, (xg, params), g)))
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(*runs)):
            raise AssertionError(f"{tag} adain() on strided slices at {shape} does not repeat")
        dp_r = torch.zeros_like(params)
        dp_r[:, :c], dp_r[:, c:2 * c] = bwd_r[2], bwd_r[1]
        y, dx, dp = runs[0]
        auto = {"y": (y, y_r, Y_ATOL * max(1.0, float(w_c.float().abs().max()))),
                "dx": (dx, bwd_r[0], DX_RTOL * float(bwd_r[0].float().abs().max())),
                "dparams": (dp, dp_r, DX_RTOL * float(dp_r.float().abs().max()))}
        for k, (got, want, tol) in auto.items():
            err, sh = _out_error(got, want, tol)
            errs[f"adain() {k}"], share[f"adain() {k}"] = err, sh
            if not sh <= 1.0:
                raise AssertionError(f"{tag} adain() on strided slices at {shape}: {k} {err:.3g} "
                                     f"({sh:.2f} of its tolerance {tol:.3g})")
        log(f"{tag} strided w/bias, (B, 4C x 3) = {tuple(params.shape)}, rows {12 * c} apart, at "
            f"{shape}: the bits of contiguous copies, bit-repeatable, dw and dbias contiguous "
            f"{dtype}; " + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " | share of tol "
            + " ".join(f"{k} {v:.2f}" for k, v in share.items()))
        for k, v in errs.items():
            key = "fwd" if k in ("y", "adain() y") else "bwd" if k not in ("mean", "rstd") else None
            if key:
                out[key] = max(out.get(key, 0.0), v)
                out[f"{key}_share"] = max(out.get(f"{key}_share", 0.0), share[k])
    return out


def phase_adain_parity():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, offset, w_kind in ADAIN_CASES:
        errs, _ = _adain_case("[adain parity]", shape, offset, w_kind, gen, torch.float32)
        worst["fwd"] = max(worst["fwd"], errs["y"])
        worst["bwd"] = max(worst["bwd"], errs["dx"], errs["dw"], errs["db"])
    strided = _adain_strided("[adain parity]", torch.float32, gen)
    worst["fwd"] = max(worst["fwd"], strided["fwd"])
    worst["bwd"] = max(worst["bwd"], strided["bwd"])
    log(f"[adain parity] {len(ADAIN_CASES)} cases and strided w/bias at 2 shapes pass: max |dy| "
        f"{worst['fwd']:.3g}, max |d(dx, dw, db)| {worst['bwd']:.3g}")
    return worst


def _adain_times(tag, smi, dtype, gen):
    """At the MUNIT step and sample shapes, in ``dtype``: the kernels beside
    the plain version, the bound and the PyTorch call that computes the same
    function on the (1, B*C, H, W) view (``F.instance_norm`` forward,
    ``native_batch_norm_backward`` backward, held to the plain version
    first), by CUDA events and by device time (``device_ms``); in bf16 also
    the float32 kernels on the same values widened. Then forward + backward
    through ``adain()`` with w and bias as column slices of a (B, 4C x 3) tensor,
    sliced in the call as the residual block does, beside ``F.instance_norm``
    through autograd. Returns one step's sums over its ``ADAIN_PER_STEP``
    launches at ``ADAIN_STEP_SHAPE``."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import adain as ta

    bf16 = dtype is torch.bfloat16
    elem = 2 if bf16 else 4
    out, both = {}, {}
    for shape in (ADAIN_STEP_SHAPE, ADAIN_SAMPLE_SHAPE):
        x, w, bias, g = (t.to(dtype) for t in _adain_inputs(shape, 0.0, "normal", gen))
        b, c, h, wd = shape
        planes, n = b * c, x.numel()
        _, mean, rstd = ta.adain_fwd_ref(x, w, bias, EPS)
        x1, g1 = x.view(1, planes, h, wd), g.view(1, planes, h, wd)
        w1, b1 = w.flatten(), bias.flatten()
        w1f = w1.float()  # native_batch_norm_backward's weight, converted outside the clock

        def lib_fwd():
            return F.instance_norm(x1, weight=w1, bias=b1, eps=EPS)

        def lib_bwd():
            return torch.ops.aten.native_batch_norm_backward(
                g1, x1, w1f, None, None, mean, rstd, True, EPS, [True, True, True])

        # The yardsticks must compute the same function: held to the plain
        # version as the kernels are (bf16: within two bf16 ulps).
        plain = (ta.adain_fwd_ref(x, w, bias, EPS)[0], *ta.adain_bwd_ref(g, x, w, mean, rstd))
        lib_err = max(float((a.reshape(r.shape).float() - r.float()).abs().max())
                      / max(1.0, float(r.float().abs().max()))
                      for a, r in zip((lib_fwd(), *lib_bwd()), plain))
        if lib_err > (2 * BF16_ULP if bf16 else DX_RTOL):
            raise AssertionError(f"{tag} the library calls differ from AdaIN at {shape}: "
                                 f"{lib_err:.3g}")
        reps = max(20, min(200, int(2e8 / n)))
        fns = {"fwd": (lambda: ta.adain_fwd(x, w, bias, EPS),
                       lambda: ta.adain_fwd_ref(x, w, bias, EPS), lib_fwd),
               "bwd": (lambda: ta.adain_bwd(g, x, w, mean, rstd),
                       lambda: ta.adain_bwd_ref(g, x, w, mean, rstd), lib_bwd)}
        if bf16:
            x32, w32, b32, g32 = (t.float() for t in (x, w, bias, g))
            fp32 = {"fwd": lambda: ta.adain_fwd(x32, w32, b32, EPS),
                    "bwd": lambda: ta.adain_bwd(g32, x32, w32, mean, rstd)}
        # Bytes: x in and y out, w and bias in and mean and rstd (float32)
        # out per plane; g and x in and dx out, w in, mean and rstd in, dw
        # and dbias out. Operations: 8 a forward element (sum; centred
        # square; normalise and affine), 9 a backward element (xh; the two
        # sums; dx).
        t = {}
        for k, nbytes, flops in (("fwd", 2 * elem * n + (2 * elem + 8) * planes, 8 * n),
                                 ("bwd", 3 * elem * n + (3 * elem + 8) * planes, 9 * n)):
            kern, ref, lib = fns[k]
            t[k] = {"ms": cuda_ms(kern, reps), "plain_ms": cuda_ms(ref, reps),
                    "library_ms": cuda_ms(lib, reps), "device_ms": device_ms(kern, reps),
                    "library_device_ms": device_ms(lib, reps)}
            if bf16:
                t[k]["fp32_ms"] = cuda_ms(fp32[k], reps)
            t[k]["bound_ms"], t[k]["bound_by"] = bound_ms(flops, nbytes)
            o = t[k]
            log(f"{tag} {k} {str(shape):18s} kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f}, "
                f"bound {o['bound_ms']:.4f} ({o['bound_by']}), library {o['library_ms']:.4f}"
                + (f", fp32 kernel {o['fp32_ms']:.4f}" if bf16 else "")
                + f" ({o['bound_ms'] / o['ms']:.1%} of bound); device time kernel "
                f"{fmt_ms(o['device_ms'], 0)}, library {fmt_ms(o['library_device_ms'], 0)}")
        out[shape] = t

        params = _style_params(b, c, dtype, gen)
        params.requires_grad_()
        xg, x1g = x.clone().requires_grad_(), x1.clone().requires_grad_()
        w1g, b1g = w1.clone().requires_grad_(), b1.clone().requires_grad_()
        both[shape] = {
            "adain_ms": cuda_ms(lambda: torch.autograd.grad(
                ta.adain(xg, params[:, c:2 * c], params[:, :c], EPS), (xg, params), g), reps),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                F.instance_norm(x1g, weight=w1g, bias=b1g, eps=EPS), (x1g, w1g, b1g), g1), reps)}
        log(f"{tag} fwd+bwd {str(shape):14s} through autograd: adain() on column slices of a "
            f"(B, 4C x 3) tensor {both[shape]['adain_ms']:.4f} ms, F.instance_norm "
            f"{both[shape]['library_ms']:.4f} ms")
    step = {k: {key: add_ms(0.0, ADAIN_PER_STEP, v) for key, v in out[ADAIN_STEP_SHAPE][k].items()
                if key != "bound_by"} for k in ("fwd", "bwd")}
    for k, lib in (("fwd", "F.instance_norm"), ("bwd", "native_batch_norm_backward")):
        step[k]["bound_by"] = out[ADAIN_STEP_SHAPE][k]["bound_by"]
        o = step[k]
        log(f"{tag} one step's {ADAIN_PER_STEP} {k} launches: kernel {o['ms']:.3f} ms, plain "
            f"{o['plain_ms']:.3f}, bound {o['bound_ms']:.3f}, {lib} {o['library_ms']:.3f}"
            + (f", fp32 kernel {o['fp32_ms']:.3f}" if bf16 else "")
            + f"; device time kernel {fmt_ms(o['device_ms'], 0)}, {lib} "
            f"{fmt_ms(o['library_device_ms'], 0)}; kernel/library by events "
            f"{o['ms'] / o['library_ms']:.2f}")
    step["autograd"] = {key: ADAIN_PER_STEP * v for key, v in both[ADAIN_STEP_SHAPE].items()}
    log(f"{tag} one step's {ADAIN_PER_STEP} calls through autograd, fwd+bwd: adain() on strided "
        f"slices {step['autograd']['adain_ms']:.3f} ms, F.instance_norm "
        f"{step['autograd']['library_ms']:.3f} ms")
    log(f"{tag} on {torch.cuda.get_device_name(0)} ({smi})")
    return step


def phase_adain_time(smi):
    """``[adain time]``: ``_adain_times`` in float32."""
    import torch

    return _adain_times("[adain time]", smi, torch.float32,
                        torch.Generator(device="cuda").manual_seed(4))


def adain_kernel_counts(dtype, shape, gen, calls: int = 20) -> dict:
    """The device kernels (torch.profiler, ``call_kernels``) of ``calls``
    calls each, in ``dtype`` at ``shape``: of ``adain_fwd`` and of
    ``adain_bwd`` with w and bias contiguous and as column slices of a
    (B, 4C x 3) tensor, and of ``adain()`` on the slices, forward alone and
    forward and backward through autograd (the backward's kernels include
    autograd's routing of dw and dbias into the (B, 4C x 3) gradient)."""
    import torch

    from tpugan_torch.ops import adain as ta

    b, c = shape[:2]
    x, w, bias, g = (t.to(dtype) for t in _adain_inputs(shape, 0.0, "normal", gen))
    params = _style_params(b, c, dtype, gen)
    _, mean, rstd = ta.adain_fwd_ref(x, w, bias, EPS)
    out = {}
    for layout, (wl, bl) in (("contiguous", (w, bias)),
                             ("strided", (params[:, c:2 * c], params[:, :c]))):
        out[f"adain_fwd {layout}"] = call_kernels(lambda: ta.adain_fwd(x, wl, bl, EPS), calls,
                                                  calls)
        out[f"adain_bwd {layout}"] = call_kernels(lambda: ta.adain_bwd(g, x, wl, mean, rstd),
                                                  calls, calls)
    pg = params.clone().requires_grad_()
    xg = x.clone().requires_grad_()

    def block():
        return ta.adain(xg, pg[:, c:2 * c], pg[:, :c], EPS)

    out["adain() fwd"] = call_kernels(block, calls)
    out["adain() fwd+bwd"] = call_kernels(lambda: torch.autograd.grad(block(), (xg, pg), g),
                                          calls)
    log(f"[adain launches] {str(dtype):14s} {str(shape):18s} kernels a call: " + ", ".join(
        f"{k} {len(v) / calls:g}" for k, v in out.items())
        + f"; adain() fwd+bwd: {_kernel_mix(out['adain() fwd+bwd'], calls)}")
    return out


def phase_adain_launches():
    """``[adain launches]``: ``adain_kernel_counts`` in float32 and bf16 at
    the MUNIT step and sample shapes. Each ``adain_fwd`` and ``adain_bwd``
    call, on contiguous and on strided w/bias, must be exactly one kernel,
    the affine instance of ``instance_norm.cu``'s pair in that direction.
    Returns, for every count, the traced kernels a call and the distinct
    kernels (by name) a call made."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(10)
    calls = 20
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (ADAIN_STEP_SHAPE, ADAIN_SAMPLE_SHAPE):
            counts = adain_kernel_counts(dtype, shape, gen, calls)
            for key, names in counts.items():
                out[f"{dtype} {shape} {key}"] = {"traced_a_call": len(names) / calls,
                                                 "distinct": len(set(names))}
                if key.startswith("adain()"):
                    continue
                if not one_affine_kernel_a_call(names, calls, key[6:9]):
                    raise AssertionError(
                        f"[adain launches] {key} in {dtype} at {shape}: {len(names)} kernels "
                        f"traced in {calls} calls, expected one in_act_{key[6:9]}_*<..., true> "
                        f"a call: {sorted(set(names))[:6]}")
    log(f"[adain launches] every adain_fwd and adain_bwd call is one kernel, in float32 and "
        f"bf16, on contiguous and strided w/bias, at {ADAIN_STEP_SHAPE} and {ADAIN_SAMPLE_SHAPE}")
    return out


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
        f"time (profiler on): device busy {busy_ms / prof_ms:.1%}; kernels a step "
        f"{len(kernels) / n_prof:.1f}, of them {slice_backward_kernels(prof) / n_prof:.1f} in "
        f"autograd's SliceBackward0 (the style parameters' slices)")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[munit slice]   {tot / n_prof:9.3f} ms/step  x{cnt / n_prof:5.0f}  {name[:110]}")
    # The port's own kernels: in_act_{fwd,bwd}_warp<kAffine> (regime A) and
    # in_act_{fwd,bwd}_slice<kVec, kAffine> (regime B).
    ours = {}
    for name, (tot, cnt) in by_name.items():
        for k in ("fwd", "bwd"):
            if f"in_act_{k}_warp<" in name or f"in_act_{k}_slice<" in name:
                key = ("adain_" if _affine(name) else "in_") + k
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
            "in_fwd_bf16": tin.fwd_launches_bf16, "in_bwd_bf16": tin.bwd_launches_bf16,
            "in_fwd_bf16_captured": tin.fwd_captured_bf16,
            "in_bwd_bf16_captured": tin.bwd_captured_bf16,
            "adain_fwd": ta.adain_fwd_launches, "adain_bwd": ta.adain_bwd_launches,
            "adain_fwd_bf16": ta.adain_fwd_launches_bf16,
            "adain_bwd_bf16": ta.adain_bwd_launches_bf16,
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


# The shipped-settings replay rule. A sound replay is one more run of the
# same nondeterministic arithmetic (cuDNN's weight gradients use atomics, and
# Adam turns their rounding into steps of up to lr), exchangeable with the
# eager runs from the same seed: its distance to any one eager run has the
# distribution of a distance between two eager runs, and its distance to the
# nearest eager run is at most that. By Cantelli's one-sided inequality, for
# any distribution, P(D >= mean + k * std) <= 1 / (1 + k^2). So a module
# fails only where the replay's distance to the nearest eager run exceeds
# the mean plus REPLAY_K standard deviations of the C(n, 2) eager-eager
# distances of REPLAY_EAGER runs (distance: the largest |difference| over
# the module's tensors): at most 1 / 2501 a module for a sound replay, and
# ``replay_rule_modules`` counts the modules a run holds to it, so the
# script's own rate is at most that count over 2501 (``main`` prints it and
# fails past 1%). It replaces "within the largest eager-eager distance of 4
# runs", which a sound replay broke about 1 time in 5: the nearest of n + 1
# exchangeable runs' is the largest with chance 1 / (n + 1). A module whose
# eager runs agree bit for bit must still agree bit for bit.
REPLAY_EAGER, REPLAY_K = 6, 50.0
# Steps (or critic-family units) a dispatch in the replay-against-eager
# checks: each check captures its own graph, so the trainers whose shipped K
# is larger (DCGAN's 60, run_training's 20) replay a graph of this many steps
# there, three dispatches a run, which keeps their eager runs short.
REPLAY_CHECK_K = 10
replay_rule_modules = 0


def replay_rule(eager: list, replay: dict, tag: str = "") -> dict:
    """Holds a replayed snapshot (name -> tensor, with the generator's state
    under "draws" and the step count under "step") to the eager ones: the
    generator state, the step and every non-float tensor equal; a float
    tensor the eager runs agree on bit for bit, equal; by module (the first
    component of a name), the replay's distance to the nearest eager run
    within the mean plus ``REPLAY_K`` standard deviations of the eager-eager
    distances. Returns {module: (replay-nearest eager, largest eager-eager,
    threshold)} and the count of tensors equal bit for bit."""
    import itertools

    import torch

    global replay_rule_modules
    a = eager[0]
    if not (torch.equal(replay["draws"], a["draws"]) and int(replay["step"]) == int(a["step"])):
        raise AssertionError(f"{tag} the generator's state or the step count after the replays "
                             f"differ from the eager runs'")
    pairs = list(itertools.combinations(range(len(eager)), 2))
    rep, eag, exact = {}, {}, 0
    for name, want in a.items():
        if name in ("draws", "step"):
            continue
        if not want.dtype.is_floating_point:
            if not all(torch.equal(s[name], want) for s in [replay, *eager]):
                raise AssertionError(f"{tag} {name}: the replay or an eager run differs")
            exact += 1
            continue
        to_eager = [float((replay[name] - s[name]).abs().max()) for s in eager]
        spread = [float((eager[i][name] - eager[j][name]).abs().max()) for i, j in pairs]
        if max(spread) == 0.0 and max(to_eager) != 0.0:
            raise AssertionError(f"{tag} {name}: the eager runs agree bit for bit, the replay "
                                 f"differs by {max(to_eager):.3e}")
        exact += max(to_eager) == 0.0
        role = name.split(".")[0]
        rep[role] = [max(r, t) for r, t in zip(rep.get(role, [0.0] * len(eager)), to_eager)]
        eag[role] = [max(e, t) for e, t in zip(eag.get(role, [0.0] * len(pairs)), spread)]
    worst = {}
    for role in rep:
        d = torch.tensor(eag[role], dtype=torch.float64)
        std = float(d.std()) if len(pairs) > 1 else 0.0
        worst[role] = (min(rep[role]), float(d.max()), float(d.mean()) + REPLAY_K * std)
    replay_rule_modules += len(worst)
    for role, (near, spread, limit) in worst.items():
        if near > limit:
            raise AssertionError(f"{tag} {role}: the replay differs from the nearest of "
                                 f"{len(eager)} eager runs by {near:.3e}, past the mean + "
                                 f"{REPLAY_K:g} std of the eager-eager distances, {limit:.3e} "
                                 f"(largest {spread:.3e})")
    return worst, exact


def _replay_vs_eager(tag, make, chunks, k, deterministic=False, n_eager=REPLAY_EAGER):
    """The same state from the same seed run as eager steps ``n_eager`` times
    and through ``graph_steps`` (the warm-up call, the capture and its
    replay, a replay with new batches), each followed by one eager step.
    ``chunks`` is a tensor of (dispatches, k, ...) batches, or a tuple of
    them (images and labels), one a step argument. The replay is held to the
    eager runs by ``replay_rule``. ``deterministic`` holds cuDNN to its
    deterministic algorithms for all the runs, where every tensor must then
    agree bit for bit. Returns the largest differences by module,
    (replay-nearest eager, eager-eager, the rule's threshold)."""
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
    total = len(replay) - 2
    if deterministic:
        bad = [n for n in replay if not all(torch.equal(replay[n], s[n]) for s in snaps)]
        if bad:
            raise AssertionError(f"{tag} with deterministic cuDNN only {total + 2 - len(bad)} of "
                                 f"{total + 2} tensors agree bit for bit: {bad[:8]}")
        worst = {n.split(".")[0]: (0.0, 0.0, 0.0) for n in replay if n not in ("draws", "step")}
        exact = total
    else:
        worst, exact = replay_rule(snaps, replay, tag)
    mode = "deterministic cuDNN" if deterministic else "shipped settings"
    log(f"{tag} replay against {n_eager} eager runs ({mode}, K={k}, {n_chunks} dispatches and "
        f"one eager step after): generator state and step count equal; {exact} of {total} "
        "tensors bit for bit" + ("" if deterministic else
                                 "; by module, replay-nearest eager vs largest eager-eager vs "
                                 "the rule's threshold: " + ", ".join(
                                     f"{r} {x:.3e} vs {y:.3e} vs {z:.3e}"
                                     for r, (x, y, z) in worst.items())))
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
    n_eager = min(2 * k, 20)
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
    kernel_ms = {}
    for e in kernels:
        kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / k
    r = {"eager_ms": eager_ms, "graph_ms": graph_ms, "capture_s": fused.capture_s,
         "kernel_ms": kernel_ms,
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
    at K = ``REPLAY_CHECK_K``, and the graphed step at K = 60 beside the
    eager one."""
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

    chunks = _u8_chunks((3, REPLAY_CHECK_K, cfg.batch_size, 64, 64, 1))
    worst = {mode: _replay_vs_eager(tag, make, chunks, REPLAY_CHECK_K, mode == "deterministic",
                                    2 if mode == "deterministic" else REPLAY_EAGER)
             for mode in ("deterministic", "shipped")}
    times = _fused_times(tag, smi, make, _u8_chunks((k, cfg.batch_size, 64, 64, 1)), k,
                         cfg.batch_size)
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
    kr = REPLAY_CHECK_K
    imgs = _u8_chunks((3, kr, b, size, size, 1))
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, 10, (3, kr, b), dtype=np.int32)).to(dev)
    # With cuDNN held deterministic the eager runs agree bit for bit, and so
    # must the replay, on every tensor. The shipped settings' comparison is
    # one draw of a chaotic spread for the convolutional trainers (cuDNN's
    # atomics through 61 Adam steps): sgan's discriminator once lay 6.5e-2
    # from the nearest of four eager runs that lay at most 3.5e-2 apart.
    worst = _replay_vs_eager(tag, make, (imgs, labels), kr, deterministic=True, n_eager=2)
    labels_k = torch.from_numpy(np.random.default_rng(2).integers(
        0, 10, (RECIPE_K, b), dtype=np.int32)).to(dev)
    times = _fused_times(tag, smi, make, (_u8_chunks((RECIPE_K, b, size, size, 1)), labels_k),
                         RECIPE_K, b)
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
    near, spread, _ = out["began"]["replay_vs_eager"]["aux"]
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

            r = _step_report(tag, smi, unit, 2, f"unit of {cfg.n_critic} batches",
                             cfg.n_critic * cfg.batch_size, IM2IM_PROFILED, IM2IM_TRACES)
        else:
            step = mod.make_step(cfg, state)
            r = _step_report(tag, smi, lambda: step(state, a, b), IM2IM_TIMED, "step",
                             cfg.batch_size, IM2IM_PROFILED, IM2IM_TRACES)
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


# stargan 3 batches (one g_step at batch 0, n_critic 5) and unit 3, each
# sampling at batch 0 (unit also at 2) with a checkpoint.
NEW_SLICE = {"stargan": (3, 5), "unit": (3, 2)}


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
            rd = _step_report(f"{tag} d_step", smi, lambda: d_step(state, imgs, labels, c),
                              IM2IM_TIMED // 2, "d_step", cfg.batch_size, IM2IM_PROFILED,
                              IM2IM_TRACES)
            rg = _step_report(f"{tag} g_step", smi, lambda: g_step(state, imgs, labels, c), 3,
                              "g_step", cfg.batch_size, IM2IM_PROFILED, IM2IM_TRACES)
            r = {"d_step": rd, "g_step": rg,
                 **{k: rd[k] + rg[k] for k in ("ms", "device_ms", "in_device_ms", "kernels")
                    if rd[k] is not None and rg[k] is not None}}
            r.setdefault("device_ms", None)
            r.setdefault("in_device_ms", None)
        else:
            b = torch.from_numpy(rng.integers(0, 256, imgs.shape, dtype=np.uint8)).to(dev)
            step = unit.make_step(cfg, state)
            r = _step_report(tag, smi, lambda: step(state, imgs, b), IM2IM_TIMED // 2, "step",
                             cfg.batch_size, IM2IM_PROFILED, IM2IM_TRACES)
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


# --- --dtype bfloat16 ---------------------------------------------------------

# Steps of main() in the CycleGAN and MUNIT bf16 slices (one sample, at step
# 0), critic steps of the WGAN-GP one (a generator step every fifth), and
# steps of each dtype timed in each of the four turns of ``_dtype_turns``.
BF16_STEPS, BF16_WGAN_BATCHES, BF16_TIMED = 4, 25, 5
# The 3x3 conv from 256 to 128 channels at 128x128 after the generators'
# first upsample, at batch 2 (G on [real_a; real_b]): at fp32 cuDNN runs its
# forward through an FFT algorithm (PERF.md section 5).
UPCONV_SHAPE, UPCONV_OUT = (2, 256, 128, 128), 128


def bf16_ulp(t):
    """One bf16 ulp at the magnitude of each element of ``t``: 2^(e - 8) for
    |t| = m * 2^e with m in [0.5, 1); the smallest normal's at 0."""
    import torch

    m = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(m)
    return torch.ldexp(torch.ones_like(m), e - 8)


def _bf16_errors(got, want, atol):
    """(largest |got - want|, the largest share of its tolerance an element
    uses, whether every element is within it): one bf16 ulp at the larger
    magnitude plus ``atol``."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + atol
    return float(d.max()), float((d / tol).max()), bool((d <= tol).all())


@contextlib.contextmanager
def _compute_dtype(dtype):
    """The port's compute dtype within the block (None: float32)."""
    from tpugan_torch.nn.layers import compute_dtype, set_default_compute_dtype

    before = compute_dtype()
    set_default_compute_dtype(dtype)
    try:
        yield
    finally:
        set_default_compute_dtype(before)


def _parity_case_bf16(shape, slope, offset, gen):
    """The bf16 IN pair against its plain bf16 version at one site, both
    directions, each repeating bit for bit. Returns (max |dy|, max |ddx|, the
    largest share of its tolerance each uses)."""
    import torch

    from tpugan_torch.ops import instance_norm as tin

    x = (torch.randn(shape, device="cuda", generator=gen) + offset).bfloat16()
    g = torch.randn(shape, device="cuda", generator=gen).bfloat16()
    y_k, mean_k, rstd_k = tin.in_act_fwd(x, EPS, slope)
    y_r, mean_r, rstd_r = tin.in_act_fwd_ref(x, EPS, slope)
    dx_k = tin.in_act_bwd(g, x, mean_r, rstd_r, slope)
    dx_r = tin.in_act_bwd_ref(g, x, mean_r, rstd_r, slope)
    again = (*tin.in_act_fwd(x, EPS, slope), tin.in_act_bwd(g, x, mean_r, rstd_r, slope))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, (y_k, mean_k, rstd_k, dx_k))):
        raise AssertionError(f"bf16 IN at {shape} slope {slope} does not repeat bit for bit")
    dtypes = (y_k.dtype, dx_k.dtype, mean_k.dtype, rstd_k.dtype)
    if dtypes != (torch.bfloat16, torch.bfloat16, torch.float32, torch.float32):
        raise AssertionError(f"bf16 IN at {shape}: dtypes (y, dx, mean, rstd) {dtypes}")
    y_tol = Y_ATOL * (1.0 + abs(offset))
    y_err, y_share, y_ok = _bf16_errors(y_k, y_r, y_tol)
    stat_err = float(torch.maximum((mean_k - mean_r).abs().max(), (rstd_k - rstd_r).abs().max()))
    dx_tol = DX_RTOL * float(dx_r.float().abs().max()) + 1e-7
    dx_err, dx_share, dx_ok = _bf16_errors(dx_k, dx_r, dx_tol)
    if not (y_ok and dx_ok and stat_err <= y_tol):
        raise AssertionError(
            f"bf16 kernel disagrees at {shape} slope {slope} offset {offset}: y {y_err:.3g} "
            f"({y_share:.2f} of tol 1 ulp + {y_tol:.3g}), stats {stat_err:.3g}, dx {dx_err:.3g} "
            f"({dx_share:.2f} of tol 1 ulp + {dx_tol:.3g})")
    return y_err, dx_err, y_share, dx_share


def phase_in_bf16():
    """``[in bf16 parity]``: the bf16 IN pair against its plain bf16 version
    at every (shape, slope) site of the CycleGAN path (step and sample
    shapes at slopes 0, 0.2 and 1) and of the MUNIT path, plus ragged planes
    (H*W odd, and H*W % 8 = 4: bf16's scalar path where float32 takes the
    vector one), a warp's ragged plane and a mean of 100 std; within one bf16
    ulp plus the float32 tolerances, repeating bit for bit. ``[in bf16
    time]``: the times at each CycleGAN step shape and MUNIT step site beside
    the plain bf16 version, the library call on bf16, the float32 kernel and
    the bound at 4 bytes an element forward and 6 backward."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    extra = [((2, 8, 31, 31), sl, 0.0) for sl in SLOPES]
    extra += [((2, 8, 30, 30), sl, 0.0) for sl in SLOPES]
    extra += [((3, 5, 1, 7), sl, 0.0) for sl in SLOPES]
    extra += [((2, 64, 64, 64), sl, 100.0) for sl in SLOPES]
    cases = {
        "cyclegan": [(s, sl, 0.0) for s in {**STEP_SHAPES, **SAMPLE_SHAPES} for sl in SLOPES]
        + extra,
        "munit": [(s, sl, 0.0) for s, sl in {**MUNIT_IN_STEP, **MUNIT_IN_SAMPLE}],
    }
    worst = {}
    for path, sites in cases.items():
        w = {"fwd": 0.0, "bwd": 0.0, "fwd_share": 0.0, "bwd_share": 0.0}
        for shape, slope, offset in sites:
            errs = _parity_case_bf16(shape, slope, offset, gen)
            for key, v in zip(("fwd", "bwd", "fwd_share", "bwd_share"), errs):
                w[key] = max(w[key], v)
        worst[path] = w
        log(f"[in bf16 parity] {path}: {len(sites)} cases pass, each repeating bit for bit: max "
            f"|dy| {w['fwd']:.3g} ({w['fwd_share']:.2f} of its tolerance), max |ddx| "
            f"{w['bwd']:.3g} ({w['bwd_share']:.2f}); tol one bf16 ulp plus y "
            f"{Y_ATOL:g}*(1+|offset|), dx {DX_RTOL:g} of max|dx|")
    times = {
        "cyclegan": _in_times("[in bf16 time]", [(s, 0.0, n) for s, n in STEP_SHAPES.items()],
                              [], gen, torch.bfloat16),
        "munit": _in_times("[munit in bf16 time]",
                           [(s, sl, n) for (s, sl), n in MUNIT_IN_STEP.items()], [], gen,
                           torch.bfloat16),
    }
    return worst, times


def _library_or_none(tag, fn):
    """``fn`` if it runs, else None (logged): a library call that does not
    take these dtypes is not measured."""
    try:
        fn()
        return fn
    except RuntimeError as e:
        log(f"{tag} library call not measured: {str(e).splitlines()[0][:160]}")
        return None


def phase_adain_bf16(smi):
    """``[adain bf16 parity]``: the bf16 AdaIN pair (bf16 x, w, bias and g)
    against its plain bf16 version at ``ADAIN_CASES`` and on strided w/bias
    (``_adain_strided``), both directions, each repeating bit for bit,
    within one bf16 ulp plus the float32 tolerances; ``[adain bf16 time]``:
    ``_adain_times`` in bf16. Returns the worst errors and one step's
    sums."""
    import torch

    tag = "[adain bf16 parity]"
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_share": 0.0, "bwd_share": 0.0}
    for shape, offset, w_kind in ADAIN_CASES:
        errs, share = _adain_case(tag, shape, offset, w_kind, gen, torch.bfloat16)
        worst["fwd"], worst["fwd_share"] = max(worst["fwd"], errs["y"]), max(worst["fwd_share"],
                                                                          share["y"])
        worst["bwd"] = max(worst["bwd"], errs["dx"], errs["dw"], errs["db"])
        worst["bwd_share"] = max(worst["bwd_share"], share["dx"], share["dw"], share["db"])
    strided = _adain_strided(tag, torch.bfloat16, gen)
    worst = {k: max(v, strided[k]) for k, v in worst.items()}
    log(f"{tag} {len(ADAIN_CASES)} cases and strided w/bias at 2 shapes pass: max |dy| "
        f"{worst['fwd']:.3g} ({worst['fwd_share']:.2f} of its tolerance), max |d(dx, dw, db)| "
        f"{worst['bwd']:.3g} ({worst['bwd_share']:.2f}); tol one bf16 ulp plus the float32 ones")
    return worst, _adain_times("[adain bf16 time]", smi, torch.bfloat16, gen)


def _dtype_turns(tag, smi, make, what, images):
    """Host-clock ms a step (or unit) in float32 and in bf16 in turns on the
    same entry points: float32, bf16, bf16, float32, each turn 2 warm-up and
    ``BF16_TIMED`` timed, synchronized. ``make()`` returns a callable that
    runs one step; it is built, and run, under each compute dtype."""
    import torch

    runs = {}
    for dt in (None, torch.bfloat16):
        with _compute_dtype(dt):
            runs[dt] = make()
    times = {None: [], torch.bfloat16: []}
    for dt in (None, torch.bfloat16, torch.bfloat16, None):
        with _compute_dtype(dt):
            for _ in range(2):
                runs[dt]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BF16_TIMED):
                runs[dt]()
            torch.cuda.synchronize()
            times[dt].append((time.perf_counter() - t0) / BF16_TIMED * 1e3)
    r = {"fp32_ms": sum(times[None]) / 2, "bf16_ms": sum(times[torch.bfloat16]) / 2,
         "turns": {"fp32": times[None], "bf16": times[torch.bfloat16]}}
    log(f"{tag} steady state on {torch.cuda.get_device_name(0)} ({smi}), in turns (fp32, bf16, "
        f"bf16, fp32; {BF16_TIMED} a turn after 2 warm-up; host clock, synchronized): fp32 "
        f"{r['fp32_ms']:.3f} ms a {what} {[round(v, 3) for v in times[None]]}, bf16 "
        f"{r['bf16_ms']:.3f} ms {[round(v, 3) for v in times[torch.bfloat16]]}; "
        f"{images * 1e3 / r['fp32_ms']:.2f} and {images * 1e3 / r['bf16_ms']:.2f} images/s "
        f"(fp32 with TF32 off)")
    return r, runs[torch.bfloat16]


def _top_kernels(tag, once, n_prof=2, top=12, traces=3):
    """The largest device kernels of ``n_prof`` calls of ``once``
    (torch.profiler; the most complete of ``traces`` traces, since the
    profiler drops events in some sessions), a cuDNN FFT flagged; returns
    the device ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    once()
    torch.cuda.synchronize()
    kernels, sliced = [], 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                once()
            torch.cuda.synchronize()
        got = device_kernels(prof)
        if len(got) > len(kernels):
            kernels, sliced = got, slice_backward_kernels(prof)
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    total = sum(tot for tot, _ in by_name.values()) / n_prof
    log(f"{tag} device time {total:.3f} ms a call over {n_prof} (torch.profiler); kernels a call "
        f"{len(kernels) / n_prof:.1f}, of them {sliced / n_prof:.1f} in autograd's SliceBackward0; "
        f"largest kernels:")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        fft = "  [FFT]" if "fft" in name.lower() else ""
        log(f"{tag}   {tot / n_prof:9.3f} ms  x{cnt / n_prof:4.0f}  {name[:110]}{fft}")
    return total


def _upconv_algorithms(tag):
    """The kernels cuDNN runs for the 3x3 conv from 256 to 128 channels at
    128x128 (``UPCONV_SHAPE``), forward and backward, in bf16 and in float32
    (TF32 off), each the call ``Conv2d`` makes under that compute dtype."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(UPCONV_SHAPE, device="cuda", generator=gen).to(dt).requires_grad_()
        w = (0.02 * torch.randn((UPCONV_OUT, UPCONV_SHAPE[1], 3, 3), device="cuda",
                                generator=gen)).to(dt).requires_grad_()
        g = torch.randn((UPCONV_SHAPE[0], UPCONV_OUT, *UPCONV_SHAPE[2:]), device="cuda",
                        generator=gen).to(dt)
        out[str(dt)] = _top_kernels(f"{tag} upconv {str(dt).split('.')[1]}",
                                    lambda: F.conv2d(x, w, None, 1, 1).backward(g), n_prof=1,
                                    top=6, traces=2)
    return out


def _check_fp32_checkpoints(tag, paths):
    import torch

    for path in paths:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        bad = {k: v.dtype for k, v in sd.items() if v.is_floating_point()
               and (v.dtype != torch.float32 or not bool(torch.isfinite(v).all()))}
        if bad:
            raise AssertionError(f"{tag} {path}: tensors not finite float32: {bad}")
    log(f"{tag} checkpoints {[os.path.basename(p) for p in paths]}: every tensor finite float32")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _want_only(launches, **want):
    """The launch counters ``want`` names at those counts, every other at 0."""
    return {k: want.get(k, 0) for k in launches}


def phase_cyclegan_bf16(smi):
    """``[cyclegan bf16 slice]``: ``cyclegan.main`` with ``--dtype
    bfloat16`` at 256px, batch 1, 9 residual blocks for ``BF16_STEPS`` steps
    (a sample at step 0, checkpoints): finite losses, float32 checkpoints,
    and exactly the bf16 IN launches of those steps and one sample (no
    float32 IN launch: nothing widens a map to reach the float32 kernels);
    then the step in float32 and bf16 in turns, the bf16 step's largest
    kernels, and cuDNN's kernels for the 256-to-128 conv at 128x128."""
    import numpy as np
    import torch

    from tpugan_torch.models import cyclegan

    tag = "[cyclegan bf16 slice]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cyclegan_bf16_")
    with _compute_dtype(None):
        wall, launches, _ = _run_main(cyclegan, [
            "--synthetic_data", "--n_epochs", "1", "--max_batches", str(BF16_STEPS),
            "--sample_interval", str(BF16_STEPS), "--checkpoint_interval", "1",
            "--dtype", "bfloat16"], out_dir)
    want = _want_only(launches, in_fwd_bf16=BF16_STEPS * FWD_PER_STEP + FWD_PER_SAMPLE,
                      in_bwd_bf16=BF16_STEPS * BWD_PER_STEP)
    log(f"{tag} main() took {wall:.1f} s ({BF16_STEPS} steps, one sample); launches "
        f"{_nonzero(launches)}, expected {_nonzero(want)}")
    if launches != want:
        raise AssertionError(f"{tag} launch counts {launches} != expected {want}")
    rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), BF16_STEPS)
    log(f"{tag} losses finite at all {BF16_STEPS} steps; last {rows[-1]}")
    _check_fp32_checkpoints(tag, [os.path.join(out_dir, "saved_models", "monet2photo",
                                               f"{m}_0.pth") for m in cyclegan.MODULES])

    dev = torch.device("cuda")
    cfg = cyclegan.Config(synthetic_data=True, output_dir=out_dir)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)).to(dev)
            for _ in range(2))

    def make():
        modules = cyclegan.build(cfg, dev)
        state = cyclegan.create_state(cfg, modules, dev)
        step = cyclegan.make_step(cfg, modules, dev)
        return lambda: step(state, a, b)

    turns, once = _dtype_turns(tag, smi, make, "step", 1)
    with _compute_dtype(torch.bfloat16):
        turns["bf16_device_ms"] = _top_kernels(f"{tag} bf16 step", once)
    turns["upconv_device_ms"] = _upconv_algorithms(tag)
    return {"launches": {"fwd": launches["in_fwd_bf16"], "bwd": launches["in_bwd_bf16"]},
            **turns}


def phase_munit_bf16(smi):
    """``[munit bf16 slice]``: ``munit.main`` with ``--dtype bfloat16`` at
    128px, batch 1, dim 64, 3 residual blocks for ``BF16_STEPS`` steps (a
    sample at step 0, checkpoints): finite losses, float32 checkpoints, and
    exactly the bf16 AdaIN and IN launches; then the step in float32 and
    bf16 in turns and the bf16 step's largest kernels."""
    import numpy as np
    import torch

    from tpugan_torch.models import munit

    tag = "[munit bf16 slice]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_munit_bf16_")
    with _compute_dtype(None):
        wall, launches, _ = _run_main(munit, [
            "--synthetic_data", "--n_epochs", "1", "--max_batches", str(BF16_STEPS),
            "--sample_interval", str(BF16_STEPS), "--checkpoint_interval", "1",
            "--dtype", "bfloat16"], out_dir)
    want = _want_only(
        launches, adain_fwd_bf16=BF16_STEPS * ADAIN_PER_STEP + ADAIN_PER_SAMPLE,
        adain_bwd_bf16=BF16_STEPS * ADAIN_PER_STEP,
        in_fwd_bf16=BF16_STEPS * MUNIT_IN_PER_STEP + MUNIT_IN_PER_SAMPLE,
        in_bwd_bf16=BF16_STEPS * MUNIT_IN_PER_STEP)
    log(f"{tag} main() took {wall:.1f} s ({BF16_STEPS} steps, one sample); launches "
        f"{_nonzero(launches)}, expected {_nonzero(want)}")
    if launches != want:
        raise AssertionError(f"{tag} launch counts {launches} != expected {want}")
    rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), BF16_STEPS)
    log(f"{tag} losses finite at all {BF16_STEPS} steps; last {rows[-1]}")
    _check_fp32_checkpoints(tag, [os.path.join(out_dir, "saved_models", "edges2shoes",
                                               f"{m}_0.pth") for m in munit.MODULES])

    dev = torch.device("cuda")
    cfg = munit.Config(synthetic_data=True, output_dir=out_dir)
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 256, (1, cfg.img_height, cfg.img_width, 3),
                                          dtype=np.uint8)).to(dev) for _ in range(2))

    def make():
        modules = munit.build(cfg, dev)
        state = munit.create_state(cfg, modules, dev)
        step = munit.make_step(cfg, modules, dev)
        return lambda: step(state, a, b)

    turns, once = _dtype_turns(tag, smi, make, "step", 1)
    with _compute_dtype(torch.bfloat16):
        turns["bf16_device_ms"] = _top_kernels(f"{tag} bf16 step", once)
    return {"launches": {k: launches[k] for k in ("adain_fwd_bf16", "adain_bwd_bf16",
                                                  "in_fwd_bf16", "in_bwd_bf16")}, **turns}


def phase_dcgan_bf16_fused(smi):
    """``[dcgan bf16 fused]``: ``dcgan.main --dtype bfloat16`` at 64px with
    60 steps a dispatch over 3 epochs (no kernel of the port launched), the
    replay against eager in bf16 with the shipped settings (``replay_rule``:
    bit for bit where the eager runs agree, as they all do here; the
    float32 phase keeps the deterministic-cuDNN half), the eager and graphed
    step, and a bf16 line of the bench
    (``bench.measure(..., dtype="bfloat16")``)."""
    import torch

    from tpugan_torch import bench
    from tpugan_torch.models import dcgan

    tag = "[dcgan bf16 fused]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dcgan_bf16_")
    k, epochs = DCGAN_K, DCGAN_FUSED_EPOCHS
    with _compute_dtype(None):
        wall, launches, replays = _run_main(dcgan, [
            "--synthetic_data", "--n_epochs", str(epochs), "--max_batches",
            str(DCGAN_EPOCH_BATCHES), "--img_size", "64", "--sample_interval", str(k),
            "--log_interval", "30", "--steps_per_dispatch", str(k), "--dtype", "bfloat16"],
            out_dir)
    log(f"{tag} main() with --steps_per_dispatch {k} --dtype bfloat16 took {wall:.1f} s; graph "
        f"replays {replays}, the port's kernel launches {launches}, expected none")
    if replays != epochs - 1 or any(launches.values()):
        raise AssertionError(f"{tag} {replays} replays, launches {launches}")
    _check_mnist_run(tag, out_dir, os.path.join(out_dir, "metrics.jsonl"),
                     epochs * DCGAN_EPOCH_BATCHES, k, 64, 64)

    cfg = dcgan.Config(img_size=64, synthetic_data=True, dtype="bfloat16")
    dev = torch.device("cuda")

    def make():
        state = dcgan.create_state(cfg, dcgan.build(cfg, dev), dev)
        return state, dcgan.make_step(cfg, state)

    chunks = _u8_chunks((3, REPLAY_CHECK_K, cfg.batch_size, 64, 64, 1))
    with _compute_dtype(torch.bfloat16):
        worst = {"shipped": _replay_vs_eager(tag, make, chunks, REPLAY_CHECK_K)}
        times = _fused_times(tag, smi, make, _u8_chunks((k, cfg.batch_size, 64, 64, 1)), k,
                             cfg.batch_size)
    with _compute_dtype(None):
        rec = {"metric": bench.METRIC, **bench.measure(bench.IMG_SIZE, bench.BATCH_SIZE,
                                                        bench.STEPS, dtype="bfloat16")}
    log(f"{tag} bench line: " + json.dumps(rec))
    if rec["dtype"] != "bfloat16" or not rec["value"] > 0 or rec["mode"] != "cuda_graph":
        raise AssertionError(f"{tag} unexpected bench record {rec}")
    return {"replay_vs_eager": worst, **times, "bench_images_per_sec": rec["value"]}


def phase_wgan_gp_bf16(smi):
    """``[wgan_gp bf16]``: ``wgan_gp.main --dtype bfloat16`` (batch 64,
    28x28) for ``BF16_WGAN_BATCHES`` critic steps: finite losses and exactly
    one float32 GP launch each way a critic step (the interpolate is
    float32, as in the JAX package), no other kernel of the port; then the
    schedule unit in float32 and bf16 in turns."""
    import numpy as np
    import torch

    from tpugan_torch.models import wgan_gp

    tag = "[wgan_gp bf16]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_wgan_gp_bf16_")
    with _compute_dtype(None):
        wall, launches, _ = _run_main(wgan_gp, [
            "--synthetic_data", "--n_epochs", "1", "--max_batches", str(BF16_WGAN_BATCHES),
            "--sample_interval", str(BF16_WGAN_BATCHES), "--dtype", "bfloat16"], out_dir)
    want = _want_only(launches, gp_fwd=BF16_WGAN_BATCHES, gp_bwd=BF16_WGAN_BATCHES)
    log(f"{tag} main() took {wall:.1f} s ({BF16_WGAN_BATCHES} critic steps); launches "
        f"{_nonzero(launches)}, expected {_nonzero(want)}")
    if launches != want:
        raise AssertionError(f"{tag} launch counts {launches} != expected {want}")
    rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), BF16_WGAN_BATCHES)
    log(f"{tag} losses finite in all {len(rows)} rows; last {rows[-1]}")

    cfg = wgan_gp.Config(synthetic_data=True, output_dir=out_dir)
    dev = torch.device("cuda")
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (cfg.batch_size, cfg.img_size, cfg.img_size, cfg.channels),
        dtype=np.uint8)).to(dev)

    def make():
        state = wgan_gp.create_state(cfg, wgan_gp.build(cfg, dev), dev)
        d_step, g_step = wgan_gp.make_steps(cfg, state)

        def unit():
            _, d0 = d_step(state, imgs)
            g_step(state, d0["z"])
            for _ in range(cfg.n_critic - 1):
                d_step(state, imgs)
        return unit

    turns, _ = _dtype_turns(tag, smi, make, "schedule unit", cfg.n_critic * cfg.batch_size)
    return {"launches": {"fwd": launches["gp_fwd"], "bwd": launches["gp_bwd"]}, **turns}


# --- The flags, checkpoints and FID (--profile_dir, --ragged_last_batch,
# --debug_numerics, crash-safe .pth files, eval_fid) -----------------------------------


def _trace_events(tag, directory):
    """The events of the one TensorBoard trace file under ``directory``."""
    files = [f for f in os.listdir(directory) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"{tag} {directory} holds trace files {files}, expected one")
    path = os.path.join(directory, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, os.path.getsize(path)


def _dispatch_ranges(events) -> list:
    """The ``tpugan.dispatch.<n>`` ranges of a trace, by n (the observer's
    ranges on the host; the profiler mirrors them on the device too)."""
    return sorted({int(e["name"].rsplit(".", 1)[1]) for e in events
                   if str(e.get("name", "")).startswith("tpugan.dispatch.")})


def _kernel_names(events) -> set:
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def _device_launches(launches, replays, names) -> dict:
    """Launches on the device of each counter in ``names``: calls not
    captured plus captured calls times the graph's replays."""
    return {n: launches[n] - launches.get(f"{n}_captured", 0)
            + launches.get(f"{n}_captured", 0) * replays for n in names}


def phase_flags_profile(smi):
    """``--profile_dir``: DCGAN at 64px, batch 64, with 4 steps a dispatch and
    ``--profile_steps 8`` must trace exactly dispatches 1 and 2 (the capture
    and its replay, then a replay); CycleGAN at 256px, batch 1, fp32, 4 steps
    with ``--profile_steps 1`` must trace dispatch 1 alone (a trace of about
    80 MB) and name the IN kernels. Each trace is one file that parses as JSON; names are held,
    not counts (the profiler drops events)."""
    from tpugan_torch.models import cyclegan, dcgan

    tag = "[flags profile]"
    runs = {}
    for name, mod, argv, want_in, want_ranges in (
            ("dcgan", dcgan, ["--img_size", "64", "--max_batches", "16", "--steps_per_dispatch",
                              "4", "--profile_steps", "8", "--sample_interval", "0"], False,
             [1, 2]),
            ("cyclegan", cyclegan, ["--max_batches", "4", "--profile_steps", "1",
                                    "--sample_interval", "0", "--checkpoint_interval", "-1"],
             True, [1])):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_profile_{name}_")
        prof = os.path.join(out_dir, "prof")
        wall, launches, replays = _run_main(mod, ["--synthetic_data", "--n_epochs", "1",
                                                  "--log_interval", "0", "--profile_dir", prof,
                                                  *argv], out_dir)
        events, size = _trace_events(tag, prof)
        ranges = _dispatch_ranges(events)
        kernels = _kernel_names(events)
        in_names = sorted({m.group(0) for k in kernels for m in [re.search(r"in_act_\w+", k)]
                           if m})
        log(f"{tag} {name}: main() {wall:.1f} s, graph replays {replays}, trace "
            f"{size / 1e6:.1f} MB, {len(events)} events, {len(kernels)} distinct kernels, "
            f"dispatch ranges {ranges}; IN kernels named {in_names}; launches "
            f"{_nonzero(launches)} ({smi})")
        if ranges != want_ranges:
            raise AssertionError(f"{tag} {name} traced dispatches {ranges}, expected "
                                 f"{want_ranges}")
        if not kernels:
            raise AssertionError(f"{tag} {name}: no device kernel in the trace")
        if want_in and not (any(n.startswith("in_act_fwd") for n in in_names)
                            and any(n.startswith("in_act_bwd") for n in in_names)):
            raise AssertionError(f"{tag} {name}: the trace names no in_act_fwd/in_act_bwd kernel")
        if name == "dcgan" and replays != 3:
            raise AssertionError(f"{tag} dcgan: {replays} graph replays, expected 3")
        runs[name] = {"seconds": wall, "launches": _device_launches(
            launches, replays, ("in_fwd", "in_bwd")), "ranges": ranges}
    return runs


def _losses_snapshot(state, rows) -> dict:
    """``_snapshot`` of a state with the run's losses beside it, one float64
    tensor a loss key (the module "losses" to ``replay_rule``)."""
    import torch

    snap = _snapshot(state)
    for key in sorted({k for r in rows for k in r} - {"step"}):
        snap[f"losses.{key}"] = torch.tensor([r.get(key, 0.0) for r in rows],
                                             dtype=torch.float64)
    return snap


def _ragged_run(mod, cfg):
    """``mod.run(cfg)`` with its rows; the GP launches, the batch of each GP
    call not captured in a graph, and the graph replays it made."""
    import torch

    from tpugan_torch.ops import mlp_gp
    from tpugan_torch.train import loop

    batches = {"fwd": [], "bwd": []}
    launch = {"fwd": mlp_gp._launch_fwd, "bwd": mlp_gp._launch_bwd}

    def recorder(d):
        def call(x, *args):
            if not torch.cuda.is_current_stream_capturing():
                batches[d].append(int(x.shape[0]))
            return launch[d](x, *args)
        return call

    _reset_port_launches()
    loop.reset_graph_counts()
    mlp_gp._launch_fwd, mlp_gp._launch_bwd = recorder("fwd"), recorder("bwd")
    try:
        t0 = time.perf_counter()
        state = mod.run(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mlp_gp._launch_fwd, mlp_gp._launch_bwd = launch["fwd"], launch["bwd"]
    with open(cfg.metrics_jsonl) as f:
        rows = [json.loads(line) for line in f]
    return state, rows, _port_launches(), loop.graph_replays, batches, wall


def phase_flags_ragged(smi):
    """``--ragged_last_batch`` with 4 steps a dispatch over the synthetic
    set's 4,096 images at batch 60: 68 full batches and a tail of 16, run
    eagerly after the last replay. WGAN-GP (the MLP critic at 784-512-256-1,
    n_critic 5: 13 units, 3 dispatches, then 9 batches unfused, the tail
    last): the tail's critic step launches ``mlp_gp_fwd``/``mlp_gp_bwd`` at
    batch 16, one GP launch each way a critic step on the device, and the
    run's state and losses held to 6 eager runs by ``replay_rule``. DCGAN at
    64px (17 dispatches and the tail), with cuDNN held deterministic: state
    and losses bit for bit those of 2 eager runs."""
    import dataclasses

    import torch

    from tpugan_torch.models import dcgan, wgan_gp

    tag = "[flags ragged]"
    out = {}
    n_batches = -(-4096 // 60)
    for name, mod, base, n_eager, deterministic in (
            ("wgan_gp", wgan_gp, wgan_gp.Config(), REPLAY_EAGER, False),
            ("dcgan", dcgan, dcgan.Config(img_size=64), 2, True)):
        shipped = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            snaps, runs = [], {}
            for k in [1] * n_eager + [4]:
                out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_ragged_{name}_{k}_")
                cfg = dataclasses.replace(
                    base, synthetic_data=True, n_epochs=1, batch_size=60, steps_per_dispatch=k,
                    ragged_last_batch=True, sample_interval=0, log_interval=0,
                    output_dir=out_dir, metrics_jsonl=os.path.join(out_dir, "m.jsonl"))
                state, rows, launches, replays, gp_batches, wall = _ragged_run(mod, cfg)
                if [r["step"] for r in rows] != list(range(n_batches)):
                    raise AssertionError(f"{tag} {name} K={k}: rows {[r['step'] for r in rows]}")
                if not all(math.isfinite(v) for r in rows for v in r.values()):
                    raise AssertionError(f"{tag} {name} K={k}: non-finite losses")
                snap = _losses_snapshot(state, rows)
                if k == 1:
                    snaps.append(snap)
                runs[k] = (snap, launches, replays, gp_batches, wall)
        finally:
            torch.backends.cudnn.deterministic = shipped
        snap, launches, replays, gp_batches, wall = runs[4]
        device = _device_launches(launches, replays, ("gp_fwd", "gp_bwd"))
        log(f"{tag} {name}: {n_batches} batches (tail {4096 % 60}) with K=4 in {wall:.2f} s, "
            f"graph replays {replays}, eager K=1 {runs[1][4]:.2f} s; launches on the device "
            f"{device}; GP batches not captured (fwd) {gp_batches['fwd']} ({smi})")
        if name == "wgan_gp":
            if device != {"gp_fwd": n_batches, "gp_bwd": n_batches}:
                raise AssertionError(f"{tag} wgan_gp GP launches on the device {device}, "
                                     f"expected {n_batches} each way")
            if gp_batches["fwd"][-1:] != [16] or gp_batches["bwd"][-1:] != [16]:
                raise AssertionError(f"{tag} wgan_gp: the tail's critic step launched no GP "
                                     f"kernel at batch 16: {gp_batches}")
        elif any(launches.values()):
            raise AssertionError(f"{tag} dcgan launched the port's kernels: {launches}")
        if deterministic:
            bad = [n for n in snap if not all(torch.equal(snap[n], s[n]) for s in snaps)]
            if bad:
                raise AssertionError(f"{tag} {name}: {len(bad)} tensors differ from the eager "
                                     f"runs with deterministic cuDNN: {bad[:8]}")
            log(f"{tag} {name}: state and losses bit for bit the {n_eager} eager runs'")
        else:
            worst, exact = replay_rule(snaps, snap, f"{tag} {name}")
            log(f"{tag} {name}: {exact} of {len(snap) - 2} tensors bit for bit; by module, "
                "fused-nearest eager vs largest eager-eager vs the rule's threshold: " + ", ".join(
                    f"{r} {x:.3e} vs {y:.3e} vs {z:.3e}" for r, (x, y, z) in worst.items()))
        out[name] = {"seconds": wall, "eager_seconds": runs[1][4], "replays": replays,
                     "launches": device}
    return out


def phase_flags_debug(smi):
    """``--debug_numerics`` on the card: CycleGAN (256px, batch 1, fp32) and
    MUNIT (128px, batch 1) for 2 steps each, every step under autograd's
    anomaly mode with the IN and AdaIN kernels launched, losses finite and
    anomaly mode off after; then a CycleGAN step fed a NaN raises
    FloatingPointError."""
    import torch

    from tpugan_torch.models import cyclegan, munit
    from tpugan_torch.models._im2im_common import first_batch
    from tpugan_torch.train.loop import StepObserver

    tag = "[flags debug_numerics]"
    out = {}
    for name, mod in (("cyclegan", cyclegan), ("munit", munit)):
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_debug_{name}_")
        wall, launches, _ = _run_main(mod, ["--synthetic_data", "--n_epochs", "1",
                                            "--max_batches", "2", "--sample_interval", "0",
                                            "--checkpoint_interval", "-1", "--log_interval", "0",
                                            "--debug_numerics"], out_dir)
        rows = _check_rows(f"{tag} {name}", os.path.join(out_dir, "metrics.jsonl"), 2)
        want = ("in_fwd", "in_bwd") + (("adain_fwd", "adain_bwd") if name == "munit" else ())
        log(f"{tag} {name}: 2 steps under anomaly mode in {wall:.1f} s, launches "
            f"{_nonzero(launches)}, last row {rows[-1]} ({smi})")
        if not all(launches[n] > 0 for n in want) or torch.is_anomaly_enabled():
            raise AssertionError(f"{tag} {name}: launches {launches}, anomaly mode "
                                 f"{torch.is_anomaly_enabled()} after the run")
        out[name] = {"seconds": wall, "launches": {n: launches[n] for n in want}}
    cfg = cyclegan.Config(synthetic_data=True, debug_numerics=True)
    dev = torch.device("cuda")
    modules = cyclegan.build(cfg, dev)
    state = cyclegan.create_state(cfg, modules, dev)
    step = StepObserver(cfg).checked(cyclegan.make_step(cfg, modules, dev))
    a, b = first_batch(cyclegan.make_loader(cfg, dev), 0)
    a = a.float()
    a[0, 0, 0, 0] = float("nan")
    try:
        step(state, a, b)
    except FloatingPointError as e:
        log(f"{tag} a CycleGAN step fed a NaN raised FloatingPointError: {str(e)[:200]}")
    else:
        raise AssertionError(f"{tag} a CycleGAN step fed a NaN raised nothing")
    if torch.is_anomaly_enabled():
        raise AssertionError(f"{tag} anomaly mode left on after the NaN step")
    return out


def phase_checkpoint(smi):
    """Crash-safe checkpoints on the card: ``pix2pix.main`` (256px, batch 1)
    for two epochs of one batch, a checkpoint each; a save of epoch 1 whose
    ``torch.save`` writes half the file and raises leaves the epoch-1 files
    as they were, with no partial or temporary file; then the ``--epoch 1``
    resume (``maybe_resume``, as ``pix2pix.run`` calls it) loads them into
    fresh modules on the card, bit for bit."""
    import dataclasses

    import torch

    from tpugan_torch.models import pix2pix
    from tpugan_torch.models._im2im_common import checkpoint_epoch, maybe_resume

    tag = "[checkpoint]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    t0 = time.perf_counter()
    state = pix2pix.main(["--synthetic_data", "--max_batches", "1", "--sample_interval", "0",
                          "--log_interval", "0", "--checkpoint_interval", "1", "--n_epochs", "2",
                          "--output_dir", out_dir])
    cfg = pix2pix.Config(output_dir=out_dir, checkpoint_interval=1)
    directory = os.path.join(out_dir, "saved_models", cfg.dataset_name)
    files = sorted(os.listdir(directory))
    want = sorted(f"{n}_{e}.pth" for n in pix2pix.MODULES for e in (0, 1))
    if files != want:
        raise AssertionError(f"{tag} {files}, expected {want}")
    saved = {n: {k: v.clone() for k, v in state.modules[n].state_dict().items()}
             for n in pix2pix.MODULES}
    with torch.no_grad():
        for m in state.modules.values():
            for p in m.parameters():
                p.add_(1.0)
    real_save = torch.save

    def failing_save(obj, path, *args, **kwargs):
        real_save(obj, path, *args, **kwargs)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        raise OSError(28, "No space left on device")

    torch.save = failing_save
    try:
        checkpoint_epoch(state.modules, cfg, 1, pix2pix.MODULES)
    except OSError:
        pass
    else:
        raise AssertionError(f"{tag} the failing save did not raise")
    finally:
        torch.save = real_save
    if sorted(os.listdir(directory)) != files:
        raise AssertionError(f"{tag} files after the failed save {sorted(os.listdir(directory))}")
    fresh = pix2pix.build(cfg, torch.device("cuda"))
    maybe_resume(fresh, dataclasses.replace(cfg, epoch=1), pix2pix.MODULES)
    for n in pix2pix.MODULES:
        for k, v in fresh[n].state_dict().items():
            if not torch.equal(v, saved[n][k]):
                raise AssertionError(f"{tag} --epoch 1 resumed {n}.{k} unlike its file")
    log(f"{tag} pix2pix: {files} written through .tmp and os.replace; a save failing midway "
        f"left them whole; the --epoch 1 resume loaded every tensor on the card bit for bit "
        f"({time.perf_counter() - t0:.1f} s on {smi})")


FID_SAMPLES, FID_BATCH = 2048, 256


def phase_fid(smi):
    """``eval_fid`` on DCGAN (its defaults: 32px, the synthetic set) with
    2,048 samples at batch 256 through the InceptionV3 and the VGG19
    extractors on the card, He-random (no weight file): the FID and the
    extractor's images/s; then the Inception forward on the card against its
    own float64 forward on the CPU on 4 images."""
    import copy

    import torch

    from tpugan_torch.metrics import eval_fid
    from tpugan_torch.metrics.fid import InceptionFeatureModel
    from tpugan_torch.nn.vgg import imagenet_normalize

    tag = "[fid]"
    out = {}
    for extractor in ("inception", "vgg"):
        args = eval_fid.parse_args(["--model", "dcgan", "--n_samples", str(FID_SAMPLES),
                                    "--batch", str(FID_BATCH), "--synthetic_data",
                                    "--data_dir", tempfile.mkdtemp(prefix="chip_smoke_fid_"),
                                    "--extractor", extractor])
        t0 = time.perf_counter()
        rec = eval_fid.evaluate(args)
        rec["seconds"] = time.perf_counter() - t0
        log(f"{tag} dcgan, {extractor}: FID {rec['fid']:.4f} ({rec['extractor']}, pretrained "
            f"{rec['pretrained']}, {rec['features']} features) on {FID_SAMPLES} real and "
            f"{FID_SAMPLES} generated images; extraction {rec['extract_s']:.3f} s, "
            f"{rec['images_per_s']:.1f} images/s; whole {rec['seconds']:.1f} s ({smi})")
        if not (rec["finite"] and math.isfinite(rec["fid"]) and rec["fid"] > 0):
            raise AssertionError(f"{tag} {extractor}: {rec}")
        out[extractor] = {k: rec[k] for k in ("fid", "images_per_s", "extract_s", "features")}
    model = InceptionFeatureModel(device="cuda")
    x = torch.rand(4, 1, 32, 32, generator=torch.Generator().manual_seed(0)) * 2 - 1
    got = model.extract(x.cuda()).cpu().double()
    module64 = copy.deepcopy(model.module).cpu().double()
    with torch.no_grad():
        want = module64(imagenet_normalize(((x.double() + 1) / 2).repeat(1, 3, 1, 1)))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"{tag} Inception forward on the card (fp32, TF32 off) against float64 on the CPU, 4 "
        f"images: max |diff| {err:.3e} of max |feature| {scale:.3e} (limit 1e-4 of it)")
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{tag} Inception card forward off its float64 forward by {err}")
    out["inception_fp64_max_abs_err"] = err
    return out


# Data parallelism (``tpugan_torch/parallel``). [dp nccl]: DCGAN at 64px,
# batch 64, K = 5, DP_NCCL_BATCHES batches through ``dcgan.main`` with and
# without a one-rank NCCL group, then pixelda at 32px, batch 64, K =
# DP_NCCL_PIXELDA_K over DP_NCCL_PIXELDA_BATCHES likewise (the IN pair and
# global BatchNorm's gathers in one captured graph). [dp gloo]: each DP_GLOO
# run's ``main`` for two batches on two gloo ranks sharing the card, against
# one process. Every trainer runs at its reference widths and image size
# (PERF.md section 4) at an even batch, and samples at batch 0
# (``--sample_interval`` past the run) on rank 0 alone; cluster_gan and
# dragan write their epoch's sheets, esrgan its preview at its full step.
DP_NCCL_K, DP_NCCL_BATCHES = 5, 15
DP_NCCL_PIXELDA_K, DP_NCCL_PIXELDA_BATCHES = 10, 30
_SAMPLE_AT_0 = ["--sample_interval", "1000"]
DP_GLOO_RUNS = {
    "dcgan": ["--img_size", "64", "--batch_size", "64"],
    "wgan_gp": ["--batch_size", "64"],
    "cyclegan": ["--batch_size", "2", "--n_residual_blocks", "9"],
    "pix2pix": ["--batch_size", "2", *_SAMPLE_AT_0],  # 256px
    "discogan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 64px
    "dualgan": ["--batch_size", "8", *_SAMPLE_AT_0],  # 128px
    "stargan": ["--batch_size", "16", *_SAMPLE_AT_0],  # 128px
    "unit": ["--batch_size", "2", *_SAMPLE_AT_0],  # 256px
    "munit": ["--batch_size", "2", *_SAMPLE_AT_0],  # 128px
    "bicyclegan": ["--batch_size", "8", *_SAMPLE_AT_0],  # 128px
    "srgan": ["--batch_size", "4", *_SAMPLE_AT_0],  # HR 256
    # The batch-local MNIST-class trainers.
    "cgan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "acgan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "sgan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "infogan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "aae": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "cluster_gan": ["--batch_size", "64"],  # 28px, n_critic 5: a full step, a d_step
    "context_encoder": ["--batch_size", "8", *_SAMPLE_AT_0],  # 128px
    "ccgan": ["--batch_size", "8", *_SAMPLE_AT_0],  # 128px
    "cogan": ["--batch_size", "32", *_SAMPLE_AT_0],  # 32px
    "pixelda": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    # The trainers with a term that couples samples (RaGAN's batch mean
    # needs --rel_avg_gan).
    "dragan": ["--batch_size", "64"],  # 32px
    "began": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "softmax_gan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 28px
    "relativistic_gan": ["--batch_size", "64", "--rel_avg_gan", *_SAMPLE_AT_0],  # 32px
    "ebgan": ["--batch_size", "64", *_SAMPLE_AT_0],  # 32px
    "esrgan": ["--batch_size", "4", "--warmup_batches", "1", "--sample_interval", "1"],  # HR 256
}
DP_GLOO_BATCHES = 2
# stargan runs one batch (a d_step and a g_step), so that its tracked IN
# buffers move only with the generator's initial weights and are held to one
# process's within rounding: over a second batch they follow the first Adam
# step's noise (on an H100, 8.4e-4 of their largest plus one, past the
# envelope).
# pixelda runs one batch too: its step amplifies rounding once Adam's first
# step has moved every weight by up to lr (on an H100, one process against
# one NCCL rank: the first step's losses 2.1e-7 apart, 1.1 relative within
# 30 steps, ``[dp nccl]``), so a second batch's losses sit at the 1e-3 limit
# (8.1e-4 over two gloo ranks).
DP_GLOO_BATCHES_OF = {"stargan": 1, "pixelda": 1}
DP_GLOO_TRACKED_RTOL = 1e-4  # stargan's tracked IN buffers against one process


def dp_gloo_batches(name: str) -> int:
    return DP_GLOO_BATCHES_OF.get(name, DP_GLOO_BATCHES)


def dp_gloo_launches(name: str) -> tuple:
    """The port's kernel launches of a DP_GLOO_RUNS main, by counter: a
    rank's in its ``dp_gloo_batches`` steps (each rank runs every kernel call
    of the step on its rows), and rank 0's sampler's at batch 0. dualgan and
    stargan take a d_step every batch and a g_step on batch 0 (``n_critic``
    5); the sites and counts are ``IM2IM_IN``'s, MUNIT's and CycleGAN's."""
    b = dp_gloo_batches(name)
    units = IM2IM_IN.get(name, {})
    if name == "wgan_gp":
        return {"gp_fwd": b, "gp_bwd": b}, {}
    if name == "cyclegan":
        return {"in_fwd": b * FWD_PER_STEP, "in_bwd": b * BWD_PER_STEP}, {}
    if name == "munit":
        return ({"in_fwd": b * MUNIT_IN_PER_STEP, "in_bwd": b * MUNIT_IN_PER_STEP,
                 "adain_fwd": b * ADAIN_PER_STEP, "adain_bwd": b * ADAIN_PER_STEP},
                {"in_fwd": MUNIT_IN_PER_SAMPLE, "adain_fwd": ADAIN_PER_SAMPLE})
    if units:
        # (n_critic 5: the g_step of batch 0 alone; pixelda's classifier
        # also runs forward only on MNIST-M each step, ``telemetry``)
        seq = ([u for u in ("step", "telemetry") if u in units] * b if "step" in units
               else ["d_step"] * b + ["g_step"])
        steps = {f"in_{d}": sum(im2im_per_unit(name, u, d) for u in seq)
                 for d in ("fwd", "bwd")}
        # context_encoder's, ccgan's and pixelda's samplers reach no IN
        sample = {"in_fwd": im2im_per_unit(name, "sample", "fwd")} if "sample" in units else {}
        return steps, sample
    return {}, {}


def _state_dicts(state) -> dict:
    return {f"{role}.{k}": v.detach().cpu().clone()
            for role, m in state.modules.items() for k, v in m.state_dict().items()}


def adam_envelope(lr, b1, b2, steps) -> float:
    """How far apart two runs of ``steps`` Adam updates can carry a
    parameter whatever their gradients: twice the sum over steps t of Adam's
    largest move lr * |m_t| / sqrt(v_t) (bias-corrected; eps only shrinks
    it), which by Cauchy-Schwarz is lr * sqrt(sum_i a_i^2 / c_i) for the
    weights a_i of gradient i in m_t and c_i in v_t. Step 1 moves lr, step 2
    at most 1.054 lr at (0.5, 0.999). The noise of a near-zero gradient (a
    bias that feeds a norm) can take either sign in either run."""
    total = 0.0
    for t in range(1, steps + 1):
        ratio = sum(((1 - b1) * b1 ** (t - i) / (1 - b1 ** t)) ** 2
                    / ((1 - b2) * b2 ** (t - i) / (1 - b2 ** t)) for i in range(1, t + 1))
        total += math.sqrt(ratio)
    return 2 * lr * total


def _dp_held(tag, got, want, cfg, steps, hold_buffers=True) -> dict:
    """Two runs of the same Adam steps, one data-parallel, held to each
    other: every parameter element within ``adam_envelope``; running
    statistics within the envelope times their largest magnitude plus one:
    they are running means of activations of networks whose parameters
    drift apart within it, a weight (such as a BatchNorm scale) scaling an
    activation by its share, a bias (such as a conv's before a BatchNorm,
    whose true gradient is 0, so the two runs' Adam steps take either sign)
    shifting it by as much absolutely. ``hold_buffers`` False only reports
    them. Returns the largest differences of parameters and of running
    statistics, the latter over that scale."""
    import torch

    bound = adam_envelope(cfg.lr, cfg.b1, cfg.b2, steps) + 1e-6
    worst = {"param": 0.0, "buffer": 0.0, "envelope": bound}
    for k, w in want.items():
        g = got[k]
        if not w.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise AssertionError(f"{tag} {k}: {g} against {w}")
            continue
        d = float((g - w).abs().max())
        if "running" in k:
            share = d / (float(w.abs().max()) + 1.0)
            worst["buffer"] = max(worst["buffer"], share)
            if hold_buffers and share > bound:
                raise AssertionError(f"{tag} {k}: off by {d:.3e}, {share:.3e} of its largest, "
                                     f"past {bound:.3e}")
        else:
            worst["param"] = max(worst["param"], d)
            if d > bound:
                raise AssertionError(f"{tag} {k}: off by {d:.3e}, past Adam's envelope "
                                     f"{bound:.3e} over {steps} steps")
    return worst


def phase_dp_nccl(smi):
    """``dcgan.main`` at 64px, batch 64, fp32, K = 5 steps a CUDA graph,
    without data parallelism and then inside a one-rank NCCL group (its
    all-reduces and BatchNorm gathers captured in the graph with the steps):
    the graph's replays, the losses and parameters against the run without
    it; then ``_fused_times`` of the step both ways (images/s), and the
    device time of the replay's NCCL kernels."""
    import torch
    import torch.distributed as dist

    from tpugan_torch.models import dcgan
    from tpugan_torch.parallel.dryrun import free_port
    from tpugan_torch.parallel.mesh import auto_sharding, replicate_for

    tag = "[dp nccl]"
    k, n = DP_NCCL_K, DP_NCCL_BATCHES
    argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", str(n), "--img_size", "64",
            "--sample_interval", "0", "--log_interval", "0", "--steps_per_dispatch", str(k)]
    cfg = dcgan.Config(img_size=64, synthetic_data=True)
    dev = torch.device("cuda", 0)
    chunk = _u8_chunks((k, cfg.batch_size, 64, 64, 1), seed=3)
    runs, times = {}, {}
    shipped = torch.backends.cudnn.deterministic
    for mode in ("one process", "nccl"):
        if mode == "nccl":
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                    rank=0, world_size=1, device_id=dev)
        try:
            out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_nccl_")
            torch.backends.cudnn.deterministic = True
            try:
                from tpugan_torch.train import loop

                loop.reset_graph_counts()
                state = dcgan.main(argv + ["--output_dir", out_dir, "--metrics_jsonl",
                                           os.path.join(out_dir, "metrics.jsonl")])
                torch.cuda.synchronize()
                replays = loop.graph_replays
            finally:
                torch.backends.cudnn.deterministic = shipped
            if (state.dp is None) != (mode == "one process"):
                raise AssertionError(f"{tag} {mode}: state.dp is {state.dp}")
            if replays != n // k - 1:
                raise AssertionError(f"{tag} {mode}: {replays} replays, expected {n // k - 1}")
            rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n)
            runs[mode] = (rows, _state_dicts(state))

            def make(dp_on=mode == "nccl"):
                st = dcgan.create_state(cfg, dcgan.build(cfg, dev), dev)
                st = replicate_for(auto_sharding(cfg.batch_size, dev) if dp_on else None, st)
                return st, dcgan.make_step(cfg, st)

            times[mode] = _fused_times(f"{tag} {mode}", smi, make, chunk, k, cfg.batch_size)
        finally:
            if mode == "nccl":
                dist.destroy_process_group()
    (rows1, sd1), (rows_dp, sd_dp) = runs["one process"], runs["nccl"]
    loss_err = max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(rows_dp, rows1)
                   for key in ("d_loss", "g_loss"))
    first_err = max(abs(rows_dp[0][key] - rows1[0][key]) / abs(rows1[0][key])
                    for key in ("d_loss", "g_loss"))
    if first_err > 1e-4 or loss_err > 1e-2:
        raise AssertionError(f"{tag} losses off the one-process run's: first step {first_err:.3e}"
                             f" (limit 1e-4), any step {loss_err:.3e} (limit 1e-2)")
    # Losses and parameters are held; the running statistics are reported:
    # a running mean follows the bias of the conv that feeds its BatchNorm,
    # whose near-zero gradient Adam turns into moves of up to lr in either
    # run and which the normalization absorbs (4.3e-2 of the largest running
    # mean seen after 15 steps, with the losses within 7.4e-6).
    worst = _dp_held(tag, sd_dp, sd1, cfg, n, hold_buffers=False)
    # Device time a step by kernel name, data-parallel replay minus the
    # one-process one: global BatchNorm's elementwise kernels and the
    # collectives. One rank's collectives are copies, which NCCL may run as
    # memcpys rather than kernels of its own.
    base, dp_ms = times["one process"]["kernel_ms"], times["nccl"]["kernel_ms"]
    nccl = {name: ms for name, ms in dp_ms.items() if "nccl" in name.lower()}
    extra = sorted(((ms - base.get(name, 0.0), name) for name, ms in dp_ms.items()),
                   reverse=True)
    memcpy = sum(d for d, name in extra if "Memcpy" in name or "Memset" in name)
    nccl_s = json.dumps({x: round(v, 4) for x, v in nccl.items()}) if nccl else "none"
    ips = {m: cfg.batch_size * 1e3 / t["graph_ms"] for m, t in times.items()}
    log(f"{tag} dcgan.main, {n} steps at K = {k}, cuDNN deterministic, with a one-rank NCCL "
        f"group against one process: {n // k - 1} replays each; losses within {loss_err:.3e} "
        f"relative (first step {first_err:.3e}); parameters within {worst['param']:.3e} (Adam's "
        f"envelope {worst['envelope']:.3e}); running statistics {worst['buffer']:.3e} of their "
        f"largest apart (reported, not held)")
    log(f"{tag} graphed step on {torch.cuda.get_device_name(0)} ({smi}): one process "
        f"{times['one process']['graph_ms']:.3f} ms, {ips['one process']:.1f} images/s; "
        f"one-rank NCCL {times['nccl']['graph_ms']:.3f} ms, {ips['nccl']:.1f} images/s "
        f"({ips['nccl'] / ips['one process'] - 1:+.1%}); eager "
        f"{times['one process']['eager_ms']:.3f} and {times['nccl']['eager_ms']:.3f} ms; device "
        f"time a step "
        f"{fmt_ms(times['one process']['device_ms'], 0)} and "
        f"{fmt_ms(times['nccl']['device_ms'], 0)}"
        f" ms; NCCL kernels {nccl_s} (ms a step), memcpys and memsets {memcpy:+.4f} ms a step")
    log(f"{tag} device ms a step by kernel name, the data-parallel replay minus the one-process "
        f"one, largest first: " + ", ".join(f"{name[:70]} {d:+.4f}" for d, name in extra[:8])
        + f"; in all {sum(d for d, _ in extra):+.4f} ms a step over {len(dp_ms)} names")
    return {"images_per_s": ips, "graph_ms": {m: t["graph_ms"] for m, t in times.items()},
            "device_ms": {m: t["device_ms"] for m, t in times.items()}, "nccl_device_ms": nccl,
            "memcpy_delta_ms": memcpy,
            "loss_rel_err": loss_err, "param_max_abs_err": worst["param"],
            "pixelda": _dp_nccl_pixelda(smi)}


def _dp_nccl_pixelda(smi):
    """``pixelda.main`` at its reference configuration (32px, batch 64) over
    ``DP_NCCL_PIXELDA_BATCHES`` batches, cuDNN deterministic: with
    ``DP_NCCL_PIXELDA_K`` steps a CUDA graph without data parallelism and
    inside a one-rank NCCL group (there the IN pair, global BatchNorm's
    gathers and the gradient all-reduce run inside one captured graph), and
    in the group one step a dispatch. Held: the replays; the IN launches on
    the device (wrapper calls not captured, plus captured calls times
    replays: 18 forward and 15 backward a step); the group's graphed rows
    bit for bit its eager ones; the first step's losses within 1e-4 of one
    process's (after it Adam's first step turns the rounding of global
    BatchNorm against cuDNN's into moves of up to lr, which pixelda's steps
    amplify, so the later steps are reported); the sample at batch 0
    gathered and written by rank 0."""
    import torch
    import torch.distributed as dist

    from tpugan_torch.models import pixelda
    from tpugan_torch.parallel.dryrun import free_port

    tag = "[dp nccl]"
    k, n = DP_NCCL_PIXELDA_K, DP_NCCL_PIXELDA_BATCHES
    per_step = {d: sum(im2im_per_unit("pixelda", u, d) for u in ("step", "telemetry"))
                for d in ("fwd", "bwd")}
    dev = torch.device("cuda", 0)
    runs = {}
    shipped = torch.backends.cudnn.deterministic
    for mode, fused_k in (("one process", k), ("nccl", k), ("nccl eager", 1)):
        if mode != "one process":
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                    rank=0, world_size=1, device_id=dev)
        try:
            out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_nccl_pixelda_")
            torch.backends.cudnn.deterministic = True
            try:
                wall, launches, replays = _run_main(pixelda, [
                    "--synthetic_data", "--n_epochs", "1", "--max_batches", str(n),
                    "--log_interval", "0", "--steps_per_dispatch", str(fused_k),
                    *_SAMPLE_AT_0], out_dir)
            finally:
                torch.backends.cudnn.deterministic = shipped
            device = {d: launches[f"in_{d}"] - launches[f"in_{d}_captured"]
                      + launches[f"in_{d}_captured"] * replays for d in ("fwd", "bwd")}
            want = {d: n * per_step[d] for d in ("fwd", "bwd")}
            want_replays = n // fused_k - 1 if fused_k > 1 else 0
            if replays != want_replays or device != want:
                raise AssertionError(f"{tag} pixelda {mode}: {replays} replays (expected "
                                     f"{want_replays}), IN launches on the device {device} "
                                     f"(expected {want}), calls {launches}")
            _check_grids(tag, [os.path.join(out_dir, "images", "0.png")],
                         _grid_wh(5, 3 * 32, 32, 5))
            rows = _check_rows(tag, os.path.join(out_dir, "metrics.jsonl"), n)
            runs[mode] = (rows, wall, device)
            log(f"{tag} pixelda.main, {n} steps at K = {fused_k} ({mode}): {wall:.1f} s, "
                f"{replays} replays; IN launches on the device {device} ({per_step} a step), "
                f"wrapper calls {launches['in_fwd']}/{launches['in_bwd']}, "
                f"{launches['in_fwd_captured']}/{launches['in_bwd_captured']} captured; wrote "
                f"images/0.png")
        finally:
            if mode != "one process":
                dist.destroy_process_group()
    rows1, rows_dp, rows_eager = (runs[m][0] for m in ("one process", "nccl", "nccl eager"))
    keys = ("d_loss", "g_loss")
    first_err = max(abs(rows_dp[0][key] - rows1[0][key]) / abs(rows1[0][key]) for key in keys)
    loss_err = max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(rows_dp, rows1)
                   for key in keys)
    replay_equal = rows_dp == rows_eager
    log(f"{tag} pixelda in a one-rank NCCL group on {torch.cuda.get_device_name(0)} ({smi}): "
        f"graphed rows bit for bit the eager ones: {replay_equal}; against one process the "
        f"first step's losses within {first_err:.3e} relative (limit 1e-4), any step "
        f"{loss_err:.3e} (reported)")
    if not replay_equal or first_err > 1e-4:
        raise AssertionError(f"{tag} pixelda: graphed rows equal to eager: {replay_equal}; "
                             f"first step {first_err:.3e} off one process's")
    return {"in_device_launches": {d: sum(r[2][d] for r in runs.values()) for d in ("fwd", "bwd")},
            "first_step_rel_err": first_err,
            "loss_rel_err": loss_err, "replay_equals_eager": replay_equal,
            "main_s": {m: r[1] for m, r in runs.items()}}


def _dp_gloo_rank(rank, world, port, out_dir, results):
    """One process of ``phase_dp_gloo`` on the one card: a rank of a gloo
    group, or with ``rank`` None the one process the ranks are held to
    (no group), which runs beside them; then each DP_GLOO_RUNS main for its
    ``dp_gloo_batches``; its states, losses and the port's kernel launches to
    ``out_dir``."""
    import traceback

    label = "single" if rank is None else f"rank{rank}"
    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, REPO)
        torch.cuda.set_device(0)
        if rank is not None:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world)
        try:
            got = {}
            for name, extra in DP_GLOO_RUNS.items():
                got[name] = _dp_gloo_run(name, extra, os.path.join(out_dir, f"{name}_{label}"))
            torch.save(got, os.path.join(out_dir, f"{label}.pt"))
        finally:
            if rank is not None:
                dist.destroy_process_group()
        results.put((label, "ok"))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((label, traceback.format_exc()))


def _dp_gloo_run(name, extra, out_dir):
    """``<name>.main`` for its ``dp_gloo_batches`` on the card: its final
    state, metric rows, the port's launches and wall seconds."""
    import importlib

    import torch

    mod = importlib.import_module(f"tpugan_torch.models.{name}")
    # (cluster_gan has no sample interval: it writes its sheets each epoch)
    quiet = ["--sample_interval", "0"] if hasattr(mod.Config, "sample_interval") else []
    argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", str(dp_gloo_batches(name)),
            *quiet, "--log_interval", "0", *extra]
    os.makedirs(out_dir, exist_ok=True)
    _reset_port_launches()
    t0 = time.perf_counter()
    state = mod.main(argv + ["--output_dir", out_dir, "--metrics_jsonl",
                             os.path.join(out_dir, "metrics.jsonl")], "cuda:0")
    torch.cuda.synchronize()
    rows = []
    path = os.path.join(out_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f]
    return {"state": _state_dicts(state), "rows": rows, "launches": _port_launches(),
            "seconds": time.perf_counter() - t0, "dp": None if state.dp is None else
            (state.dp.rank, state.dp.world)}


def _dp_gloo_held(tag, smi, name, extra, r0, r1, single) -> dict:
    """One DP_GLOO_RUNS main of ``phase_dp_gloo``: ranks 0 and 1 (``r0``,
    ``r1``) against each other and against one process (``single``): the
    descriptors, equal states, ``_dp_held``, the losses within 1e-3
    relative, each rank's launches against ``dp_gloo_launches``. Raises
    AssertionError; returns the numbers."""
    import importlib

    import torch

    if (r0["dp"], r1["dp"], single["dp"]) != ((0, 2), (1, 2), None):
        raise AssertionError(f"{tag} {name}: dp {r0['dp']}, {r1['dp']}, {single['dp']}")
    for key, v in r0["state"].items():
        if not torch.equal(v, r1["state"][key]):
            raise AssertionError(f"{tag} {name}: the ranks differ at {key}")
    mod = importlib.import_module(f"tpugan_torch.models.{name}")
    cfg = mod.Config()
    if not hasattr(cfg, "b1"):  # cluster_gan's betas are constants of the reference's
        cfg = types.SimpleNamespace(lr=cfg.lr, b1=mod.B1, b2=mod.B2)
    batches = dp_gloo_batches(name)
    worst = _dp_held(f"{tag} {name}", r0["state"], single["state"], cfg, batches)
    loss_err = max((abs(a[key] - b[key]) / max(abs(b[key]), 1e-6)
                    for a, b in zip(r0["rows"], single["rows"]) for key in b if key != "step"),
                   default=0.0)
    if len(r0["rows"]) != len(single["rows"]) or loss_err > 1e-3:
        raise AssertionError(f"{tag} {name}: losses off by {loss_err:.3e} (limit 1e-3): "
                             f"{r0['rows']} against {single['rows']}")
    keys = ("in_fwd", "in_bwd", "adain_fwd", "adain_bwd", "gp_fwd", "gp_bwd")
    per_rank = [{key: r["launches"][key] for key in keys if r["launches"][key]}
                for r in (r0, r1)]
    steps, sample = dp_gloo_launches(name)
    want = [{key: steps.get(key, 0) + sample.get(key, 0) for key in {*steps, *sample}},
            steps]
    if per_rank != want:
        raise AssertionError(f"{tag} {name}: ranks 0 and 1 launched {per_rank}, expected "
                             f"{want} (rank 0's sampler {sample})")
    launches = {key: r0["launches"][key] + r1["launches"][key] for key in keys}
    tracked = ""
    if name == "stargan":
        # The tracked IN buffers: equal on both ranks (above), and within
        # rounding of one process's (``DP_GLOO_BATCHES_OF``).
        diff = max(float((r0["state"][k] - single["state"][k]).abs().max())
                   / max(float(single["state"][k].abs().max()), 1e-12)
                   for k in single["state"] if "running" in k)
        if diff > DP_GLOO_TRACKED_RTOL:
            raise AssertionError(f"{tag} {name}: the tracked IN buffers off by {diff:.3e} of "
                                 f"their largest, past {DP_GLOO_TRACKED_RTOL:g}")
        tracked = f"; the tracked IN buffers within {diff:.3e} of their largest"
    log(f"{tag} {name} ({' '.join(extra)}), {batches} batches on 2 gloo ranks on "
        f"{torch.cuda.get_device_name(0)} against one process: losses within "
        f"{loss_err:.3e} relative, parameters within {worst['param']:.3e} (Adam's envelope "
        f"{worst['envelope']:.3e}), running statistics within {worst['buffer']:.3e} of their "
        f"largest plus one; both ranks' states equal{tracked}; kernel launches by rank {per_rank} "
        f"(rank 0's sampler {sample}); main {r0['seconds']:.1f} s on rank 0, "
        f"{single['seconds']:.1f} s in the one process beside the ranks ({smi})")
    return {"launches": launches, "launches_by_rank": per_rank, "sampler_launches": sample,
            "loss_rel_err": loss_err, "param_max_abs_err": worst["param"],
            "rank_s": r0["seconds"], "single_s": single["seconds"]}


def phase_dp_gloo(smi):
    """Two spawned ranks in a gloo group, both on the card (NCCL refuses two
    ranks on one device): each DP_GLOO_RUNS main for two batches (stargan
    one), eager, with the IN pair (CycleGAN, pix2pix, discogan, dualgan,
    stargan, unit, MUNIT), the AdaIN pair (MUNIT) and the GP pair (WGAN-GP)
    launched inside the data-parallel steps; each held to one process on the
    card running the same main, spawned beside the ranks (losses,
    parameters, running statistics, stargan's tracked IN buffers within
    rounding), and each rank's launches to ``dp_gloo_launches``, rank 0's
    sampler's counted apart."""
    import multiprocessing
    import queue as queue_mod

    import torch

    from tpugan_torch.parallel.dryrun import free_port

    tag = "[dp gloo]"
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_gloo_")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port, world = free_port(), 2
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dp_gloo_rank, args=(r, world, port, out_dir, results))
             for r in (*range(world), None)]
    for p in procs:
        p.start()
    try:
        for _ in procs:
            label, status = results.get(timeout=600)
            if status != "ok":
                raise AssertionError(f"{tag} {label} failed:\n{status}")
    except queue_mod.Empty:
        raise AssertionError(f"{tag} a process sent nothing in 600 s") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    got = {label: torch.load(os.path.join(out_dir, f"{label}.pt"), weights_only=False)
           for label in ("rank0", "rank1", "single")}
    out, failed = {}, []
    for name, extra in DP_GLOO_RUNS.items():
        try:
            out[name] = _dp_gloo_held(tag, smi, name, extra, got["rank0"][name],
                                      got["rank1"][name], got["single"][name])
        except AssertionError as e:  # every run is held before the phase fails
            log(f"{tag} FAILED: {e}")
            failed.append(str(e))
    log(f"{tag} the two rank processes and the one beside them took {ranks_s:.1f} s, start-up "
        f"included")
    if failed:
        raise AssertionError(f"{tag} {len(failed)} of {len(DP_GLOO_RUNS)} runs failed: "
                             + "; ".join(failed))
    return out


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
    adain_calls = _timed_phase("adain launches", phase_adain_launches)
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
    in_bf16_worst, in_bf16_time = _timed_phase("in bf16", phase_in_bf16)
    adain_bf16_worst, adain_bf16_time = _timed_phase("adain bf16", lambda: phase_adain_bf16(smi))
    bf16 = {"cyclegan": _timed_phase("cyclegan bf16 slice", lambda: phase_cyclegan_bf16(smi)),
            "munit": _timed_phase("munit bf16 slice", lambda: phase_munit_bf16(smi)),
            "dcgan fused": _timed_phase("dcgan bf16 fused", lambda: phase_dcgan_bf16_fused(smi)),
            "wgan_gp": _timed_phase("wgan_gp bf16", lambda: phase_wgan_gp_bf16(smi))}
    flags = {"profile": _timed_phase("flags profile", lambda: phase_flags_profile(smi)),
             "ragged": _timed_phase("flags ragged", lambda: phase_flags_ragged(smi)),
             "debug_numerics": _timed_phase("flags debug_numerics",
                                            lambda: phase_flags_debug(smi))}
    _timed_phase("checkpoint", lambda: phase_checkpoint(smi))
    flags["fid"] = _timed_phase("fid", lambda: phase_fid(smi))
    log("[flags summary] " + json.dumps(flags))
    dp = {"nccl": _timed_phase("dp nccl", lambda: phase_dp_nccl(smi)),
          "gloo": _timed_phase("dp gloo", lambda: phase_dp_gloo(smi))}
    log("[dp summary] " + json.dumps(dp))
    rate = replay_rule_modules / (1.0 + REPLAY_K ** 2)
    log(f"[replay rule] {replay_rule_modules} modules held to the shipped-settings rule (mean + "
        f"{REPLAY_K:g} std of {REPLAY_EAGER} eager runs' distances): false-alarm rate for a "
        f"sound replay at most {replay_rule_modules} / {1 + REPLAY_K ** 2:g} = {rate:.2%}")
    if rate > 0.01:
        raise AssertionError(f"[replay rule] the script's false-alarm bound {rate:.2%} is past 1%")
    log("[bf16 summary] " + json.dumps({
        name: {k: v for k, v in r.items() if k in ("fp32_ms", "bf16_ms", "turns",
                                                    "bf16_device_ms", "upconv_device_ms",
                                                    "launches", "eager_ms", "graph_ms",
                                                    "bench_images_per_sec", "replay_vs_eager")}
        for name, r in bf16.items()}))
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
        # The flags' runs count launches only: their error is not read there
        # (the parity phases hold the pair at the same shapes).
        for path, r in (("cyclegan profile_dir", flags["profile"]["cyclegan"]),
                        ("cyclegan debug_numerics", flags["debug_numerics"]["cyclegan"]),
                        ("munit debug_numerics", flags["debug_numerics"]["munit"]),
                        *((f"{name} dp gloo", dp["gloo"][name])
                          for name in ("cyclegan", "pix2pix", "discogan", "dualgan", "stargan",
                                       "unit", "munit", "context_encoder", "ccgan",
                                       "pixelda"))):
            by_path[path] = {"launches": r["launches"][f"in_{k}"]}
        # pixelda's three runs in [dp nccl], two of them inside one-rank NCCL
        # groups (launches on the device, a captured call once a replay)
        by_path["pixelda dp nccl"] = {"launches": dp["nccl"]["pixelda"]["in_device_launches"][k]}
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
            "max_abs_err": max(p["max_abs_err"] for p in by_path.values() if "max_abs_err" in p),
            "ms": c["ms"],
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
            "wgan_gp ragged_last_batch cuda_graph": {
                "launches": flags["ragged"]["wgan_gp"]["launches"][f"gp_{k}"],
                "replays": flags["ragged"]["wgan_gp"]["replays"]},
            "wgan_gp dp gloo": {"launches": dp["gloo"]["wgan_gp"]["launches"][f"gp_{k}"]},
        }
        kernels.append({
            "name": f"mlp_gp_{k}", "route": "cuda", "source": gp_src,
            "replaces": replaces[f"mlp_gp_{k}"],
            "launches": sum(p["launches"] for p in by_path.values()), "by_path": by_path,
            "max_abs_err": gp_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"],
            "graph_ms": t["graph_ms"],
            "cublas_products_device_ms": t["cublas_products_device_ms"],
        })
    for k in ("fwd", "bwd"):
        t = adain_time[k]
        by_path = {"munit": {"launches": munit_launches[f"adain_{k}"]},
                   "munit debug_numerics": {
                       "launches": flags["debug_numerics"]["munit"]["launches"][f"adain_{k}"]},
                   "munit dp gloo": {"launches": dp["gloo"]["munit"]["launches"][f"adain_{k}"]}}
        kernels.append({
            "name": f"adain_{k}", "route": "cuda", "source": in_src,
            "replaces": replaces[f"adain_{k}"],
            "launches": sum(p["launches"] for p in by_path.values()), "by_path": by_path,
            "max_abs_err": adain_worst[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
            "kernels_a_call": adain_calls[
                f"torch.float32 {ADAIN_STEP_SHAPE} adain_{k} strided"]["distinct"],
            "autograd_fwd_bwd": adain_time["autograd"],
            "times_of": f"one munit step, {ADAIN_PER_STEP} launches",
        })
    # The bf16 forms: the IN pair runs on the CycleGAN and MUNIT bf16
    # slices, its times one bf16 CycleGAN step's; AdaIN on the MUNIT one.
    for k in ("fwd", "bwd"):
        by_path = {
            path: {"launches": n, "max_abs_err": in_bf16_worst[path][k],
                   "tolerance_used": in_bf16_worst[path][f"{k}_share"], **in_bf16_time[path][k]}
            for path, n in (("cyclegan", bf16["cyclegan"]["launches"][k]),
                            ("munit", bf16["munit"]["launches"][f"in_{k}_bf16"]))}
        c = by_path["cyclegan"]
        kernels.append({
            "name": f"in_act_{k}_bf16", "route": "cuda", "source": in_src,
            "replaces": replaces[f"in_act_{k}"],
            "launches": sum(p["launches"] for p in by_path.values()),
            "max_abs_err": max(p["max_abs_err"] for p in by_path.values()), "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": "bytes",
            "library_ms": c["library_ms"], "device_ms": c["device_ms"], "fp32_ms": c["fp32_ms"],
            "times_of": f"one bf16 cyclegan step, {FWD_PER_STEP} launches", "by_path": by_path,
        })
    for k in ("fwd", "bwd"):
        t = adain_bf16_time[k]
        kernels.append({
            "name": f"adain_{k}_bf16", "route": "cuda", "source": in_src,
            "replaces": replaces[f"adain_{k}"],
            "launches": bf16["munit"]["launches"][f"adain_{k}_bf16"],
            "max_abs_err": adain_bf16_worst[k], "tolerance_used": adain_bf16_worst[f"{k}_share"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"], "fp32_ms": t["fp32_ms"],
            "kernels_a_call": adain_calls[
                f"torch.bfloat16 {ADAIN_STEP_SHAPE} adain_{k} strided"]["distinct"],
            "autograd_fwd_bwd": adain_bf16_time["autograd"],
            "times_of": f"one bf16 munit step, {ADAIN_PER_STEP} launches",
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
