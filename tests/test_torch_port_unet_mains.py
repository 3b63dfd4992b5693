"""A few-batch ``main`` of each of the port's U-Net im2im trainers, pix2pix,
discogan and dualgan, on the CPU: the rows' steps and keys, the logged
batches and the PNGs by name and size of the JAX trainers' loops
(``tpugan/models/<name>.py:run``), finite losses, checkpoints under the
reference's names and ``--epoch`` resume; and sampling that leaves the
training draws alone. Their steps against the JAX package's are in
``tests/test_torch_port_unet_im2im.py``.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    png_size,
    run_main,
)

from tpugan_torch.models import discogan as dg_t
from tpugan_torch.models import dualgan as du_t
from tpugan_torch.models import pix2pix as p2p_t

CPU = torch.device("cpu")
TRAINERS = {"pix2pix": p2p_t, "discogan": dg_t, "dualgan": du_t}


def _grid(n, h, w, nrow):
    """The size of a torchvision grid of n h x w images, nrow a row."""
    return nrow * (w + 2) + 2, -(-n // nrow) * (h + 2) + 2


# name: (argv, dataset, the rows' keys by step, the logged steps, the PNGs'
# steps and size). pix2pix at 256px and dualgan at 128px, batch 1; discogan
# at 64px, batch 2. Two epochs of 2 batches each (pix2pix: of 1).
MAINS = {
    "pix2pix": (["--max_batches", "1", "--sample_interval", "2"], "facades",
                {s: ["d_loss", "g_loss", "loss_GAN", "loss_pixel"] for s in range(2)},
                [0, 1], [0], _grid(10, 3 * 256, 256, 5)),
    "discogan": (["--max_batches", "2", "--batch_size", "2", "--sample_interval", "3"],
                 "edges2shoes",
                 {s: ["d_loss", "g_loss", "loss_GAN", "loss_cycle", "loss_pixelwise"]
                  for s in range(4)}, [0, 1, 2, 3], [0, 3], _grid(64, 64, 64, 8)),
    "dualgan": (["--max_batches", "2", "--n_critic", "2", "--sample_interval", "3"],
                "edges2shoes",
                {s: ["d_loss"] + (["g_adv", "g_cycle", "g_loss"] if s % 2 == 0 else [])
                 for s in range(4)}, [0, 2], [0, 3], _grid(32, 2 * 128, 128, 8)),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_a_few_batch_main_then_epoch_resume(tmp_path, name, capsys):
    """The rows' steps and keys, the logged batches and the PNGs by name and
    size of the JAX trainer's loop (``tpugan/models/<name>.py:run``), finite
    losses, a checkpoint of every module each epoch under the reference's
    names; then ``--epoch 1`` loads ``<module>_1.pth`` into every module."""
    argv, dataset, rows_want, logged, sampled, size = MAINS[name]
    mod_t = TRAINERS[name]
    argv = argv + ["--synthetic_data", "--n_epochs", "2", "--checkpoint_interval", "1",
                   "--log_interval", "1"]
    _, rows, pngs = run_main(lambda a: mod_t.main(a, CPU), argv, tmp_path)
    out = capsys.readouterr().out
    assert {r["step"]: sorted(k for k in r if k != "step") for r in rows} == rows_want
    assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
    assert out.count("[Epoch ") == len(logged)
    assert sorted(pngs) == sorted(os.path.join(dataset, f"{s}.png") for s in sampled)
    assert all(png_size(data) == size for data in pngs.values())
    ckpt_dir = tmp_path / "saved_models" / dataset
    assert sorted(p.name for p in ckpt_dir.iterdir()) == sorted(
        f"{m}_{e}.pth" for m in mod_t.MODULES for e in (0, 1))
    state = mod_t.main(argv + ["--epoch", "1", "--max_batches", "0", "--output_dir",
                               str(tmp_path)], CPU)
    for role in mod_t.MODULES:
        saved = torch.load(ckpt_dir / f"{role}_1.pth", weights_only=True)
        for k, v in state.modules[role].state_dict().items():
            assert torch.equal(v, saved[k]), (role, k)


def test_sampling_leaves_the_training_draws_alone(tmp_path):
    """The samplers that keep dropout on (pix2pix, dualgan) draw their masks
    from a generator of their own, ``_common.sample_generator``, seeded
    from (seed, batches_done), as the JAX samplers fold batches_done into a
    key they do not keep (``tpugan/models/pix2pix.py:210``): a dualgan
    sample leaves ``state.draws`` as it was, and the same batches_done gives
    the same sheet."""
    mod_t = du_t
    cfg = mod_t.Config(synthetic_data=True, output_dir=str(tmp_path))
    modules = mod_t.build(cfg, CPU)
    state = mod_t.create_state(cfg, modules, CPU)
    before = state.draws.get_state()
    sample = mod_t.make_sampler(cfg, modules, CPU)
    sheet = tmp_path / "images" / cfg.dataset_name / "7.png"
    sample(state, {}, 7)
    first = sheet.read_bytes()
    assert torch.equal(state.draws.get_state(), before)
    sample(state, {}, 7)
    assert sheet.read_bytes() == first
