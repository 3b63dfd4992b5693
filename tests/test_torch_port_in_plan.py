"""The launch plan of the instance-norm and AdaIN kernels
(``tpugan_torch.ops.instance_norm.plan``), on the CPU.

Every shape the CycleGAN, MUNIT and five im2im paths give the pair (the
lists of ``chip_smoke.py``), in both directions: the regime, the cluster
size, the slice's bytes and its cover of H*W, the threads and the shared
memory are what the rule says. The im2im lists themselves are held to a CPU
run of one unit of each path at batch 1, which records every IN call's
shape and slope. The kernels themselves run only on the card
(``tests/test_torch_port_kernels_gpu.py``).
"""

import collections

import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

import chip_smoke
from tpugan_torch.ops import instance_norm as tin

SHAPES = sorted(
    set(chip_smoke.STEP_SHAPES) | set(chip_smoke.SAMPLE_SHAPES)
    | {s for s, _ in chip_smoke.MUNIT_IN_STEP} | {s for s, _ in chip_smoke.MUNIT_IN_SAMPLE}
    | {chip_smoke.ADAIN_STEP_SHAPE, chip_smoke.ADAIN_SAMPLE_SHAPE}
    | {s for s, _, _ in chip_smoke.ADAIN_CASES}
    | {s for path, units in chip_smoke.IM2IM_IN.items() for unit in units
       for s, _ in chip_smoke.im2im_sites(path, unit)}
)
SMEM_LIMIT = 227 * 1024  # a CTA's shared memory on the H100
STATIC_SMEM = 512  # the regime-B kernels' own: barriers, sums (256 bytes by ptxas)


def _rule(planes, hw, direction):
    """The rule written out once more: (regime, cluster size or planes a
    CTA)."""
    if hw <= 256:
        group = 8
        while group > 1 and (planes + group - 1) // group < 132:
            group //= 2
        return "A", group
    per = 4 if direction == "fwd" else 8

    def slice_bytes(c):
        return -(-(-(-hw // c)) // 4) * 4 * per

    c = next((c for c in (1, 2, 4, 8) if slice_bytes(c) <= 64 * 1024), 8)
    while c < 8 and planes * c < 132 and slice_bytes(2 * c) >= 16 * 1024:
        c *= 2
    return "B", c


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_follows_the_rule(shape, direction):
    b, c, h, w = shape
    planes, hw = b * c, h * w
    p = tin.plan(planes, hw, direction)
    assert (p.regime, p.group) == _rule(planes, hw, direction)
    assert p.group <= tin.CLUSTER_MAX
    if p.regime == "A":
        assert hw <= 256 and p.slice == p.held == p.smem == 0
        assert p.threads == 32 * p.group and p.grid * p.group >= planes > (p.grid - 1) * p.group
        return
    per = 4 if direction == "fwd" else 8
    # The slices cover H*W exactly: none empty, the last one ragged at most.
    assert p.slice * p.group >= hw > p.slice * (p.group - 1)
    assert p.slice % 4 == 0 and (p.slice * 4) % 16 == 0  # whole float4s, bulk-copy sized
    assert p.slice * per <= 64 * 1024  # every slice of these shapes fits
    assert p.held == p.slice and p.smem == p.held * per
    assert p.smem + STATIC_SMEM <= SMEM_LIMIT
    assert p.grid == planes * p.group
    assert 64 <= p.threads <= 256 and p.threads % 32 == 0


@pytest.mark.parametrize("shape,direction,cluster", [
    ((1, 64, 256, 256), "fwd", 4), ((1, 64, 256, 256), "bwd", 8),
    ((2, 64, 256, 256), "fwd", 4), ((2, 64, 256, 256), "bwd", 8),
    ((1, 128, 128, 128), "fwd", 2), ((1, 128, 128, 128), "bwd", 2),
    ((1, 64, 128, 128), "bwd", 4),
    ((1, 256, 64, 64), "fwd", 1), ((1, 256, 64, 64), "bwd", 1),
    ((2, 256, 64, 64), "bwd", 1), ((1, 512, 16, 16), "fwd", None),
    ((1, 256, 32, 32), "fwd", 1), ((1, 256, 32, 32), "bwd", 1),
    ((40, 256, 32, 32), "bwd", 1),
])
def test_plan_at_the_named_shapes(shape, direction, cluster):
    """The cluster sizes the design names: 256x256 on 4 CTAs forward and 8
    backward; 128x128 on 2, or 4 backward at MUNIT's 64 planes; 64x64 maps
    of 256 and more planes and every 32x32 map on one CTA; 16x16 in
    regime A."""
    b, c, h, w = shape
    p = tin.plan(b * c, h * w, direction)
    if cluster is None:
        assert p.regime == "A"
    else:
        assert (p.regime, p.group) == ("B", cluster)


@pytest.mark.parametrize("hw", [257 * 257, 512 * 512, 1024 * 1024])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_large_and_ragged_planes_keep_64_kb_in_shared_memory(hw, direction):
    """Beyond 8 x 64 KB a plane runs on 8 CTAs whose slices keep their first
    64 KB in shared memory; a ragged plane's slices stay whole float4s."""
    p = tin.plan(2, hw, direction)
    per = 4 if direction == "fwd" else 8
    assert p.regime == "B" and p.group == 8
    assert p.slice * 8 >= hw > p.slice * 7 and p.slice % 4 == 0
    assert p.held == min(p.slice, 64 * 1024 // per) and p.smem <= 64 * 1024


def test_regime_a_packs_planes_until_the_sms_are_filled():
    assert tin.plan(5000, 16, "fwd").group == 8
    assert tin.plan(512, 4, "bwd").group == 2  # 256 CTAs of 2 warps
    assert tin.plan(15, 7, "fwd").group == 1


def test_plan_rejects_what_no_kernel_runs():
    with pytest.raises(ValueError):
        tin.plan(4, 64, "sideways")
    with pytest.raises(ValueError):
        tin.plan(0, 64, "fwd")


def test_launchers_refuse_cpu_tensors():
    """The launch path itself checks the device: a CPU tensor that reached
    it would raise, not run (the wrappers send CPU tensors to the plain
    versions before that)."""
    import torch

    x = torch.randn(1, 2, 4, 4)
    with pytest.raises(ValueError, match="expected all on cuda"):
        tin._launch_fwd("in_act_fwd", x, 1e-5, 0.0)
    with pytest.raises(ValueError, match="expected all on cuda"):
        tin._launch_bwd("in_act_bwd", x, x, x[0, :, 0, 0], x[0, :, 0, 0], 0.0)


def test_regime_a_takes_the_im2im_small_planes():
    """discogan's 2x2 maps at batch 64 (32,768 planes, 8 a CTA), the U-Nets'
    512-channel 2x2 and 4x4 maps at batch 1 (a plane a CTA's warp)."""
    assert tin.plan(64 * 512, 4, "fwd") == tin.Plan("A", 8, 0, 0, 256, 4096, 0)
    assert tin.plan(512, 4, "bwd").regime == "A" and tin.plan(512, 16, "fwd").group == 2


# --- The im2im site lists of chip_smoke.py, recorded on the CPU -------------------


def _u8(shape):
    return torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8))


@pytest.fixture
def recorded(monkeypatch):
    """Every IN call as {direction: Counter((shape, slope))}."""
    rec = {"fwd": collections.Counter(), "bwd": collections.Counter()}
    fwd, bwd = tin.in_act_fwd, tin.in_act_bwd

    def f(x, eps, slope):
        rec["fwd"][(tuple(x.shape), slope)] += 1
        return fwd(x, eps, slope)

    def b(g, x, mean, rstd, slope):
        rec["bwd"][(tuple(x.shape), slope)] += 1
        return bwd(g, x, mean, rstd, slope)

    monkeypatch.setattr(tin, "in_act_fwd", f)
    monkeypatch.setattr(tin, "in_act_bwd", b)
    return rec


def _check(rec, path, unit, sample_batch=None):
    """The recorded calls against chip_smoke's unit at batch 1 (a sampler's
    at its own batch divided out), then cleared."""
    want = chip_smoke.IM2IM_IN[path][unit]
    if sample_batch:
        want = {((s[0] // sample_batch, *s[1:]), sl): n for (s, sl), n in want.items()}
    assert dict(rec["fwd"]) == want, (path, unit)
    back = want if unit in chip_smoke.IM2IM_BWD_UNITS else {}
    assert dict(rec["bwd"]) == back, (path, unit)
    for c in rec.values():
        c.clear()


@pytest.mark.parametrize("path", ["pix2pix", "discogan", "dualgan", "context_encoder", "ccgan"])
def test_im2im_site_lists_are_what_a_cpu_step_records(recorded, path):
    """One unit of each path at batch 1 and the reference image size; the
    samplers' generator forwards at batch 1 (their sheets run them at 10 or
    16, which ``im2im_sites`` keeps)."""
    import importlib

    mod = importlib.import_module(f"tpugan_torch.models.{path}")
    cpu = torch.device("cpu")
    cfg = mod.Config(batch_size=1, synthetic_data=True)
    size = getattr(cfg, "img_size", None) or cfg.img_height
    state = mod.create_state(cfg, mod.build(cfg, cpu), cpu)
    x = _u8((1, size, size, 3))
    if path == "dualgan":
        d_step, g_step = mod.make_steps(cfg, state)
        d_step(state, x, x)
        _check(recorded, path, "d_step")
        g_step(state, x, x)
        _check(recorded, path, "g_step")
    else:
        mod.make_step(cfg, state)(state, *((x,) if path in ("context_encoder", "ccgan") else (x, x)))
        _check(recorded, path, "step")
    if "sample" in chip_smoke.IM2IM_IN[path]:
        gens = [m for r, m in state.modules.items() if r in ("generator", "G_AB", "G_BA")]
        real = torch.zeros(1, 3, size, size)
        with torch.no_grad():
            for G in gens:
                G.train(path != "discogan")  # discogan samples in eval mode
                G(real, generator=torch.Generator().manual_seed(0))
        _check(recorded, path, "sample", {"pix2pix": 10, "discogan": 16, "dualgan": 16}[path])


def _scaled(sites, batch, scale):
    """chip_smoke's sites at batch 1 and 1/scale of the image size."""
    return {((s[0] // batch, s[1], s[2] // scale, s[3] // scale), sl): n
            for (s, sl), n in sites.items()}


def _check_new(rec, path, unit, batch, scale, bwd=True):
    want = _scaled(chip_smoke.im2im_sites(path, unit), batch, scale)
    assert dict(rec["fwd"]) == want, (path, unit)
    assert dict(rec["bwd"]) == (want if bwd else {}), (path, unit)
    for c in rec.values():
        c.clear()


def test_new_site_lists_are_what_a_cpu_step_records(recorded):
    """stargan's d_step and g_step at 64px (its sites at 128px halved),
    unit's step at 64px (its sites at 256px quartered), both at batch 1, and
    pixelda's step at its 32px, batch 1: every IN call's shape and slope,
    each way; pixelda's classifier on MNIST-M runs forward only. The
    samplers' networks at batch 1: stargan's generator with its buffers
    frozen, unit's two encoders and two generators."""
    from tpugan_torch.models import pixelda, stargan, unit
    from tpugan_torch.nn.layers import batch_stats_frozen

    cpu = torch.device("cpu")
    cfg = stargan.Config(batch_size=1, img_height=64, img_width=64)
    state = stargan.create_state(cfg, stargan.build(cfg, cpu), cpu)
    d_step, g_step = stargan.make_steps(cfg, state)
    x, labels = _u8((1, 64, 64, 3)), torch.zeros(1, 5)
    state, out = d_step(state, x, labels)
    _check_new(recorded, "stargan", "d_step", 16, 2, bwd=False)
    g_step(state, x, labels, out["sampled_c"])
    _check_new(recorded, "stargan", "g_step", 16, 2)
    G = state.modules["generator"]
    with torch.no_grad(), batch_stats_frozen(G):
        G(torch.zeros(1, 3, 64, 64), torch.zeros(1, 5))
    _check_new(recorded, "stargan", "sample", 50, 2, bwd=False)

    cfg = unit.Config(img_height=64, img_width=64)
    state = unit.create_state(cfg, unit.build(cfg, cpu), cpu)
    x = _u8((1, 64, 64, 3))
    unit.make_step(cfg, state)(state, x, x)
    _check_new(recorded, "unit", "step", 1, 4)
    m = state.modules
    with torch.no_grad():
        real = torch.zeros(1, 3, 64, 64)
        _, z1 = m["E1"](real, generator=torch.Generator().manual_seed(0))
        _, z2 = m["E2"](real, generator=torch.Generator().manual_seed(0))
        m["G2"](z1), m["G1"](z2)
    _check_new(recorded, "unit", "sample", 5, 4, bwd=False)

    cfg = pixelda.Config(batch_size=1, n_residual_blocks=1)
    state = pixelda.create_state(cfg, pixelda.build(cfg, cpu), cpu)
    x, y = _u8((1, 32, 32, 3)), torch.zeros(1, dtype=torch.int32)
    pixelda.make_step(cfg, state)(state, x, y, x, y)
    both = chip_smoke._add_sites(chip_smoke.im2im_sites("pixelda", "step"),
                                 chip_smoke.im2im_sites("pixelda", "telemetry"))
    assert dict(recorded["fwd"]) == _scaled(both, 64, 1)
    assert dict(recorded["bwd"]) == _scaled(chip_smoke.im2im_sites("pixelda", "step"), 64, 1)


def test_the_new_paths_take_the_plans_the_issue_names():
    """unit's (1, 64, 256, 256) maps on clusters of 4 CTAs forward and 8
    backward; stargan's (16, 64, 128, 128) on one CTA forward and 2
    backward; pixelda's 8x8 to 2x2 planes at batch 64 in regime A, 8,192 to
    32,768 planes a launch."""
    assert tin.plan(64, 256 * 256, "fwd").group == 4 and tin.plan(64, 256 * 256, "bwd").group == 8
    assert tin.plan(16 * 64, 128 * 128, "fwd").group == 1
    assert tin.plan(16 * 64, 128 * 128, "bwd").group == 2
    for c, hw in ((128, 64), (256, 16), (512, 4)):
        p = tin.plan(64 * c, hw, "fwd")
        assert p.regime == "A" and p.group == 8 and p.grid == 64 * c // 8
    assert {s[0] * s[1] for s, _ in chip_smoke.im2im_sites("pixelda", "step")} == {
        8192, 16384, 32768}
