"""The yardstick's counts against the configuration files and against the
shapes worked out by hand."""

from __future__ import annotations

import json
import os

import pytest

from portbench import counting

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["dcgan-64", "cyclegan-256"])
def test_the_files_hold_the_counts(name):
    cfg = config(name)
    got = counting.count_step(name, cfg)
    assert got["flops"] == cfg["flops_per_step"]
    assert got["conv_flops"] == cfg["conv_flops_per_step"]
    assert got["in_elements"] == cfg["in_elements_per_step"]


def test_dcgan_64_is_the_headline_count():
    """179.430 GFLOP a step at 64px, batch 64 (PERF.md, PR 6)."""
    assert round(config("dcgan-64")["flops_per_step"] / 1e9, 3) == 179.430


def cyclegan_in_elements(h: int, w: int, blocks: int) -> int:
    """Elements the IN sites normalize in one step, from the shapes: a
    generator applies IN after c7s1-64 (64 at HxW), the two downs (128 at
    H/2, 256 at H/4), twice in each residual block (256 at H/4) and the two
    ups (128 at H/2, 64 at HxW); a PatchGAN after its blocks 2-4 (128 at
    H/4, 256 at H/8, 512 at H/16). A step applies the generators to six
    images (identity, translation and cycle, both ways) and the
    discriminators to six (the two fakes in the G phase, real and replayed
    fake in each D phase)."""
    g = (64 * h * w + 128 * h * w // 4 + 256 * h * w // 16 * (1 + 2 * blocks)
         + 128 * h * w // 4 + 64 * h * w)
    d = 128 * h * w // 16 + 256 * h * w // 64 + 512 * h * w // 256
    return 6 * g + 6 * d


def test_cyclegan_in_bytes_match_the_shapes():
    cfg = config("cyclegan-256")
    n = cyclegan_in_elements(256, 256, 9)
    assert cfg["in_elements_per_step"] == {"fwd": n, "bwd": n} == {"fwd": 200540160,
                                                                   "bwd": 200540160}
    # fp32: x in and y out forward, x and dy in and dx out backward.
    assert counting.in_bytes(cfg["in_elements_per_step"], 4) == 20 * n == 4010803200


def test_cyclegan_count_at_a_small_size():
    cfg = dict(config("cyclegan-256"), img_height=32, img_width=32, n_residual_blocks=1)
    got = counting.count_step("cyclegan-256", cfg)
    n = cyclegan_in_elements(32, 32, 1)
    assert got["in_elements"] == {"fwd": n, "bwd": n}
    assert got["conv_flops"] == got["flops"] > 0
