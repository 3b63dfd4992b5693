"""The launch plan of the instance-norm and AdaIN kernels
(``tpugan_torch.ops.instance_norm.plan``), on the CPU.

Every shape the CycleGAN and MUNIT paths give the pair (the lists of
``chip_smoke.py``), in both directions: the regime, the cluster size, the
slice's bytes and its cover of H*W, the threads and the shared memory are
what the rule says. The kernels themselves run only on the card
(``tests/test_torch_port_kernels_gpu.py``).
"""

import pytest

import chip_smoke
from tpugan_torch.ops import instance_norm as tin

SHAPES = sorted(
    set(chip_smoke.STEP_SHAPES) | set(chip_smoke.SAMPLE_SHAPES)
    | {s for s, _ in chip_smoke.MUNIT_IN_STEP} | {s for s, _ in chip_smoke.MUNIT_IN_SAMPLE}
    | {chip_smoke.ADAIN_STEP_SHAPE, chip_smoke.ADAIN_SAMPLE_SHAPE}
    | {s for s, _, _ in chip_smoke.ADAIN_CASES}
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
