"""The port's data path and outputs against the JAX package's, on the CPU:
synthetic domains, loader batches and the CycleGAN augmentation are
byte-identical; the PNG writer gives the same pixels; the trainer's Config
has the same flags and defaults."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from tpugan.data.im2im import resize_crop_flip_transform as rcf_j
from tpugan.data.im2im import synthetic_scene_pairs as ssp_j
from tpugan.data.im2im import unpaired_or_synthetic as uos_j
from tpugan.data.loader import UnpairedLoader as UnpairedLoader_j
from tpugan.io.images import save_image as save_image_j
from tpugan.models import cyclegan as cg_j
from tpugan_torch.data.im2im import resize_crop_flip_transform, synthetic_scene_pairs
from tpugan_torch.data.im2im import unpaired_or_synthetic
from tpugan_torch.data.loader import DeviceLoader, UnpairedLoader
from tpugan_torch.io.images import save_image
from tpugan_torch.models import cyclegan as cg_t

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_scene_pairs_identical(seed):
    a_t, b_t = synthetic_scene_pairs(6, 24, 20, seed)
    a_j, b_j = ssp_j(6, 24, 20, seed)
    assert np.array_equal(a_t, a_j) and np.array_equal(b_t, b_j)


def test_unpaired_or_synthetic_identical(tmp_path):
    got = unpaired_or_synthetic(str(tmp_path), "none", 16, 16, synthetic=False, synthetic_n=8)
    want = uos_j(str(tmp_path), "none", 16, 16, synthetic=False, synthetic_n=8)
    assert got[2] is want[2] is False
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_unpaired_folder_is_decoded_like_tpugan(tmp_path):
    rng = np.random.default_rng(2)
    for dom in ("A", "B"):
        (tmp_path / "ds" / "train" / dom).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(
                tmp_path / "ds" / "train" / dom / f"{i}.png"
            )
    got = unpaired_or_synthetic(str(tmp_path), "ds", 16, 16)
    want = uos_j(str(tmp_path), "ds", 16, 16)
    assert got[2] and want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_unpaired_loader_batches_identical(prefetch):
    a, b = ssp_j(10, 16, 16, 1)
    b = b[:7]  # unequal domains: A cycles, B is drawn from all of B
    t_loader = UnpairedLoader(a, b, 3, CPU, seed=4, prefetch=prefetch,
                              host_transform=resize_crop_flip_transform(4, 16, 16))
    j_loader = UnpairedLoader_j(a, b, 3, seed=4, host_transform=rcf_j(4, 16, 16))
    assert len(t_loader) == len(j_loader) == 3
    for epoch in (0, 1):
        got = list(t_loader.epoch(epoch))
        want = list(j_loader.epoch(epoch))
        assert len(got) == len(want)
        for (ga, gb), (wa, wb) in zip(got, want):
            assert ga.dtype == torch.uint8 and ga.device == CPU
            assert np.array_equal(ga.numpy(), np.asarray(wa))
            assert np.array_equal(gb.numpy(), np.asarray(wb))


def test_resize_crop_flip_identical():
    a, b = ssp_j(4, 32, 32, 3)
    got = resize_crop_flip_transform(7, 32, 32)((a, b), 2, 5)
    want = rcf_j(7, 32, 32)((a, b), 2, 5)
    for g, w in zip(got, want):
        assert g.shape == (4, 32, 32, 3) and np.array_equal(g, w)


def test_loader_relays_producer_errors():
    def boom(batch, epoch, bidx):
        raise ValueError("bad transform")

    loader = DeviceLoader([np.zeros((4, 2, 2, 3), np.uint8)], 2, CPU, host_transform=boom)
    with pytest.raises(ValueError, match="bad transform"):
        list(loader.epoch(0))


@pytest.mark.parametrize("channels,normalize", [(3, True), (1, False), (3, False)])
def test_save_image_png_matches_tpugan(tmp_path, channels, normalize):
    rng = np.random.default_rng(channels)
    imgs = rng.uniform(-1.2, 1.2, (5, 9, 11, channels)).astype(np.float32)
    save_image(imgs, str(tmp_path / "t.png"), nrow=3, normalize=normalize)
    save_image_j(imgs, str(tmp_path / "j.png"), nrow=3, normalize=normalize)
    with Image.open(tmp_path / "t.png") as t, Image.open(tmp_path / "j.png") as j:
        assert t.mode == j.mode and t.size == j.size
        assert np.array_equal(np.asarray(t), np.asarray(j))


def test_config_flags_and_defaults_equal_tpugan():
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(cg_t.Config)]
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(cg_j.Config)]
    assert got == want
    assert cg_t.MODULES == cg_j.MODULES
