"""Crash-safe checkpoints of the port (``tpugan_torch/io/checkpoint.py``)
against the JAX package's protocol (``tpugan/io/checkpoint.py:22-30,66-81``),
on the CPU: each ``<name>_<epoch>.pth`` is written to ``<path>.tmp`` in the
same directory and renamed over ``path``, so a save that fails midway leaves
the earlier file whole; ``--epoch N`` resumes from the files.

The payloads differ by design (the port writes the reference-layout
``state_dict``, the JAX package flax msgpack), so the comparison is of the
file names and the write-then-rename calls; values round-trip exactly.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

from tpugan.io import checkpoint as ckpt_j
from tpugan_torch.io import checkpoint as ckpt_t
from tpugan_torch.models import cyclegan as cg_t
from tpugan_torch.models import srgan as sr_t
from tpugan_torch.models._im2im_common import checkpoint_epoch

CPU = torch.device("cpu")


def _modules():
    return {"generator": torch.nn.Linear(4, 3), "discriminator": torch.nn.BatchNorm1d(3)}


def _record_replace(monkeypatch):
    """{directory: [(temporary file, final file)]} of every ``os.replace``."""
    calls, real = {}, os.replace

    def replace(src, dst):
        assert os.path.dirname(src) == os.path.dirname(dst)
        calls.setdefault(os.path.basename(os.path.dirname(dst)), []).append(
            (os.path.basename(src), os.path.basename(dst)))
        real(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    return calls


def test_save_modules_writes_the_files_of_jax_through_a_rename(tmp_path, monkeypatch):
    """The same file names, each written as ``<path>.tmp`` and renamed, on
    both sides; the port's file is the module's ``state_dict``."""
    modules = _modules()
    params = {name: {"w": np.ones(3, np.float32)} for name in modules}
    calls = _record_replace(monkeypatch)
    ckpt_t.save_modules(modules, str(tmp_path / "port"), 7, list(modules))
    ckpt_j.save_modules(params, str(tmp_path / "jax"), 7)
    assert calls["port"] == calls["jax"] == [("generator_7.pth.tmp", "generator_7.pth"),
                           ("discriminator_7.pth.tmp", "discriminator_7.pth")]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name, m in modules.items():
        sd = torch.load(tmp_path / "port" / f"{name}_7.pth", weights_only=True)
        assert list(sd) == list(m.state_dict())
        for k, v in m.state_dict().items():
            assert torch.equal(sd[k], v), (name, k)


def _failing_save(monkeypatch):
    """``torch.save`` that writes half its bytes, then raises, as a crash or
    a full disk mid-write would."""
    real = torch.save

    def save(obj, path, *args, **kwargs):
        real(obj, path, *args, **kwargs)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(torch, "save", save)


def _write(kind, modules, root, epoch):
    if kind == "im2im":
        cfg = cg_t.Config(output_dir=str(root), checkpoint_interval=1)
        checkpoint_epoch(modules, cfg, epoch, list(modules))
        return root / "saved_models" / cfg.dataset_name
    sr_t.save_checkpoints(sr_t.Config(output_dir=str(root)), modules, epoch)
    return root / "saved_models"


@pytest.mark.parametrize("kind", ["im2im", "srgan"])
def test_a_failed_save_leaves_the_earlier_checkpoint_whole(tmp_path, monkeypatch, kind):
    """A save of epoch 3 over an earlier epoch-3 file (esrgan saves within an
    epoch) that raises midway: the earlier file still loads with the earlier
    weights, and neither a partial file nor the temporary one is left. The
    im2im trainers save through ``_im2im_common.checkpoint_epoch``, srgan and
    esrgan through ``srgan.save_checkpoints``."""
    modules = {"generator": torch.nn.Linear(4, 3), "discriminator": torch.nn.Linear(3, 1)}
    directory = _write(kind, modules, tmp_path, 3)
    before = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in modules.items()}
    files = sorted(os.listdir(directory))
    with torch.no_grad():
        for m in modules.values():
            for p in m.parameters():
                p.add_(1.0)
    _failing_save(monkeypatch)
    with pytest.raises(OSError, match="No space"):
        _write(kind, modules, tmp_path, 3)
    monkeypatch.undo()
    assert sorted(os.listdir(directory)) == files
    fresh = {"generator": torch.nn.Linear(4, 3), "discriminator": torch.nn.Linear(3, 1)}
    ckpt_t.load_modules(fresh, str(directory), 3, list(fresh))
    for name, m in fresh.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[name][k]), (name, k)


def test_epoch_resume_loads_the_last_checkpoints(tmp_path):
    """``cyclegan.main`` for two epochs of one batch with a checkpoint each
    epoch, then ``--epoch 1``: every module equals its ``<name>_1.pth``."""
    argv = ["--synthetic_data", "--img_height", "32", "--img_width", "32",
            "--n_residual_blocks", "1", "--max_batches", "1", "--sample_interval", "0",
            "--log_interval", "0", "--checkpoint_interval", "1", "--output_dir", str(tmp_path)]
    cg_t.main(argv + ["--n_epochs", "2"], CPU)
    directory = tmp_path / "saved_models" / cg_t.Config().dataset_name
    assert sorted(os.listdir(directory)) == sorted(
        f"{n}_{e}.pth" for n in cg_t.MODULES for e in (0, 1))
    state = cg_t.main(argv + ["--n_epochs", "1", "--epoch", "1", "--max_batches", "0"], CPU)
    for name in cg_t.MODULES:
        saved = torch.load(directory / f"{name}_1.pth", weights_only=True)
        for k, v in state.modules[name].state_dict().items():
            assert torch.equal(v, saved[k]), (name, k)
