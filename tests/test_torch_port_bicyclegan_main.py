"""The port's bicyclegan sampler and a few-batch ``main`` on the CPU, against
the JAX package's loop (``tpugan/models/bicyclegan.py:run``): the rows'
steps and keys, the logged lines' heads, the PNGs and the checkpoints by
name, finite losses, ``--epoch`` resume; the sampler's sheet, and the
training draws and running buffers it leaves alone. The step is held to the
JAX package's in ``tests/test_torch_port_bicyclegan.py``.
"""

import os
import types

import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    png_size,
    run_main,
)
from test_torch_port_unet_im2im import jax_initial_state

from tpugan.models import bicyclegan as bg_j
from tpugan_torch.models import bicyclegan as bg_t

CPU = torch.device("cpu")
B, SIZE = 2, 128




def test_sampler_writes_the_sheet_and_leaves_the_state_alone(tmp_path):
    """One sheet of 8 validation rows, the original and ``latent_dim``
    translations a row (128px, 2 px border); the eval-mode generator leaves
    the running buffers as they were and the sampler's z leaves
    ``state.draws`` alone; the same sheet again at the same batches_done."""
    cfg = bg_t.Config(synthetic_data=True, latent_dim=2, output_dir=str(tmp_path))
    modules = bg_t.build(cfg, CPU)
    state = bg_t.create_state(cfg, modules, CPU)
    for m in modules["generator"].modules():  # running buffers away from their init
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.fill_(0.1)
            m.running_var.fill_(2.0)
    before = {k: v.clone() for k, v in modules["generator"].state_dict().items()}
    draws = state.draws.get_state()
    sample = bg_t.make_sampler(cfg, modules, CPU)
    path = tmp_path / "images" / cfg.dataset_name / "7.png"
    sample(state, {}, 7)
    first = path.read_bytes()
    assert png_size(first) == ((cfg.latent_dim + 1) * SIZE + 4, 8 * SIZE + 4)
    assert torch.equal(state.draws.get_state(), draws)
    assert modules["generator"].training
    for k, v in modules["generator"].state_dict().items():
        assert torch.equal(v, before[k]), k
    sample(state, {}, 7)
    assert path.read_bytes() == first


def test_a_few_batch_main_writes_the_rows_and_files_of_jax(tmp_path, capsys):
    """Two epochs of one batch, a sample each batch, checkpoints each epoch:
    the rows' steps and keys, the logged lines' heads, the PNGs and the
    checkpoints by name of the JAX trainer's loop; finite losses; then
    ``--epoch 1`` loads ``<module>_1.pth`` into every module."""
    argv = ["--synthetic_data", "--batch_size", str(B), "--latent_dim", "2", "--n_epochs", "2",
            "--max_batches", "1", "--sample_interval", "1", "--checkpoint_interval", "1"]
    got, create_state_j = {}, bg_j.create_state
    for side, main in (("jax", bg_j.main), ("port", lambda a: bg_t.main(a, CPU))):
        (tmp_path / side).mkdir()
        with pytest.MonkeyPatch.context() as mp:  # JAX's initial state jitted: 4x faster
            mp.setattr(bg_j, "create_state", lambda cfg, modules: jax_initial_state(
                types.SimpleNamespace(create_state=create_state_j), cfg, modules)[0])
            _, rows, pngs = run_main(main, argv, tmp_path / side)
        out = capsys.readouterr().out
        logged = [seg.split("] [")[:2] for seg in out.split("\r[Epoch ")[1:]]
        ckpts = sorted(os.listdir(tmp_path / side / "saved_models" / "edges2shoes"))
        got[side] = ([(r["step"], sorted(r)) for r in rows], logged, sorted(pngs), ckpts)
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
            assert all(png_size(data) == (3 * SIZE + 4, 8 * SIZE + 4) for data in pngs.values())
    assert got["port"] == got["jax"]
    assert got["port"][2] == ["edges2shoes/0.png", "edges2shoes/1.png"]
    assert len(got["port"][3]) == 8
    state = bg_t.main(argv + ["--epoch", "1", "--max_batches", "0", "--output_dir",
                              str(tmp_path / "port")], CPU)
    for role in bg_t.MODULES:
        saved = torch.load(tmp_path / "port" / "saved_models" / "edges2shoes" / f"{role}_1.pth",
                           weights_only=True)
        for k, v in state.modules[role].state_dict().items():
            assert torch.equal(v, saved[k]), (role, k)
