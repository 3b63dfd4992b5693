"""A few-batch ``main`` of the port's srgan and esrgan, and its
``test_on_image`` inference, on the CPU against the JAX package: the rows'
steps and keys, the logged lines' heads, the PNGs and the checkpoints by
name of the JAX trainers' loops (``tpugan/models/srgan.py:run``,
``tpugan/models/esrgan.py:run``), finite losses, the PNG sizes and
``--epoch`` resume; ``infer_image`` against the JAX ``infer_image`` on the
same generator (uint8 outputs within one step of 255 of each other). Their
steps, layers and networks are held to the JAX package's in
``tests/test_torch_port_sr.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import (
    one_torch_thread,  # noqa: F401 (autouse fixture)
    png_size,
    run_main,
)
from test_torch_port_sr import B, HR, _init, _u8

from tpugan.io.checkpoint import module_payload, save_pytree
from tpugan.models import esrgan as es_j
from tpugan.models import srgan as sr_j
from tpugan.models import test_on_image as toi_j
from tpugan.nn.sr import ESRGANGenerator as ESRGANGenerator_j
from tpugan_torch.__main__ import main as cli
from tpugan_torch.io.images import decode_png, encode_png
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import esrgan as es_t
from tpugan_torch.models import srgan as sr_t
from tpugan_torch.models import test_on_image as toi_t
from tpugan_torch.nn.sr import ESRGANGenerator

CPU = torch.device("cpu")


def test_infer_image_matches_jax(tmp_path):
    """The same one-block generator as a JAX checkpoint and as a port
    ``state_dict``, the same 16x16 PNG: both write images/outputs/sr-<name>,
    68x68 (4x, with save_image's 2 px border), within one step of 255 of
    each other; ``python -m tpugan_torch test_on_image`` writes the port's."""
    img_path = tmp_path / "face.png"
    img_path.write_bytes(encode_png(_u8((16, 16, 3), 12)))
    G_j = ESRGANGenerator_j(num_res_blocks=1)
    params, _ = _init(G_j, jnp.zeros((1, 16, 16, 3)))
    save_pytree(module_payload(params), str(tmp_path / "g_jax.pth"))
    G = ESRGANGenerator(num_res_blocks=1)
    load_jax_params(G, params)
    torch.save(G.state_dict(), tmp_path / "generator_0.pth")
    outs = {}
    for side, infer, ckpt in (("jax", toi_j.infer_image, "g_jax.pth"),
                              ("port", lambda c: toi_t.infer_image(c, CPU), "generator_0.pth")):
        mod = toi_j if side == "jax" else toi_t
        cfg = mod.Config(image_path=str(img_path), checkpoint_model=str(tmp_path / ckpt),
                         residual_blocks=1, output_dir=str(tmp_path / side))
        path = infer(cfg)
        assert path == str(tmp_path / side / "images" / "outputs" / "sr-face.png")
        outs[side] = decode_png(open(path, "rb").read())
    assert outs["port"].shape == (68, 68, 3)
    diff = np.abs(outs["port"].astype(int) - outs["jax"].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    with pytest.MonkeyPatch.context() as mp:  # the CLI's entry, on the CPU
        mp.setattr(toi_t, "main", lambda argv: es_t.main_test_on_image(argv, CPU))
        cli(["test_on_image", "--image_path", str(img_path), "--checkpoint_model",
             str(tmp_path / "generator_0.pth"), "--residual_blocks", "1", "--output_dir",
             str(tmp_path / "cli")])
    got = decode_png((tmp_path / "cli" / "images" / "outputs" / "sr-face.png").read_bytes())
    assert np.array_equal(got, outs["port"])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


MAINS = {
    "srgan": (sr_j, sr_t, ["--n_epochs", "2", "--max_batches", "2", "--sample_interval", "3",
                           "--checkpoint_interval", "1"]),
    "esrgan": (es_j, es_t, ["--n_epochs", "2", "--max_batches", "3", "--residual_blocks", "1",
                            "--warmup_batches", "2", "--sample_interval", "2",
                            "--checkpoint_interval", "3"]),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_a_few_batch_main_writes_the_rows_and_files_of_jax(tmp_path, name, capsys):
    """The rows' steps and keys, the logged lines' heads, the PNGs and the
    checkpoints by name of the JAX trainer's loop; finite losses; the PNG
    sizes (srgan: two columns, each a batch of HR images; esrgan: a row of
    LR | SR an image); then ``--epoch 1`` loads the checkpoints of epoch 1
    (esrgan's, written at batch 3, the first of epoch 1, by the batch
    interval)."""
    mod_j, mod_t, extra = MAINS[name]
    argv = ["--synthetic_data", "--batch_size", str(B), "--hr_height", str(HR),
            "--log_interval", "2"] + extra
    got = {}
    for side, main in (("jax", mod_j.main), ("port", lambda a: mod_t.main(a, CPU))):
        (tmp_path / side).mkdir()
        _, rows, pngs = run_main(main, argv, tmp_path / side)
        out = capsys.readouterr().out
        logged = [seg.split("] [")[:2] for seg in out.replace("\n", "").split("[Epoch ")[1:]]
        got[side] = ([(r["step"], sorted(r)) for r in rows], logged, sorted(pngs),
                     _files(tmp_path / side / "saved_models"))
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
            size = (2 * (HR + 4), B * (HR + 2) + 2) if name == "srgan" else \
                (2 * HR + 4, B * (HR + 2) + 2)
            assert all(png_size(data) == size for data in pngs.values())
    assert got["port"] == got["jax"]
    want = {"srgan": ["0.png", "3.png"], "esrgan": ["training/2.png", "training/4.png"]}[name]
    assert got["port"][2] == want
    assert got["port"][3] == (["discriminator_0.pth", "discriminator_1.pth", "generator_0.pth",
                               "generator_1.pth"] if name == "srgan"
                              else ["discriminator_1.pth", "generator_1.pth"])
    state = mod_t.main(argv + ["--epoch", "1", "--max_batches", "0", "--n_epochs", "1",
                               "--output_dir", str(tmp_path / "port")], CPU)
    for role in mod_t.MODULES:
        saved = torch.load(tmp_path / "port" / "saved_models" / f"{role}_1.pth",
                           weights_only=True)
        for k, v in state.modules[role].state_dict().items():
            assert torch.equal(v, saved[k]), (role, k)


@pytest.mark.parametrize("mod", [sr_t, es_t, toi_t], ids=["srgan", "esrgan", "test_on_image"])
def test_runs_raise_without_cuda(tmp_path, mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = (["--image_path", "x.png", "--checkpoint_model", "g.pth"] if mod is toi_t
            else ["--synthetic_data"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv + ["--output_dir", str(tmp_path)])


def test_srgan_loader_trains_on_every_image_of_a_folder(tmp_path):
    """With a CelebA-style folder the SR loaders take ``val_tail`` 0: every
    image trains. The JAX package's slice ``imgs[:-0]`` leaves none
    (ROADMAP 3.4), the one place the port's loader departs from it."""
    from PIL import Image

    from tpugan.data.im2im import celeba_images_or_synthetic as cios_j
    from tpugan_torch.data.im2im import celeba_images_or_synthetic

    folder = tmp_path / "faces"
    folder.mkdir()
    for i in range(3):
        Image.fromarray(_u8((12, 12, 3), 20 + i)).save(folder / f"{i:06d}.png")
    imgs, is_real = celeba_images_or_synthetic(str(tmp_path), "faces", 8, 8, val_tail=0)
    assert is_real and imgs.shape == (3, 8, 8, 3)
    assert len(cios_j(str(tmp_path), "faces", 8, 8, val_tail=0)[0]) == 0
    cfg = sr_t.Config(data_dir=str(tmp_path), dataset_name="faces", hr_height=8, batch_size=1)
    assert len(sr_t.make_loader(cfg, CPU)) == 3


@pytest.mark.parametrize("mod", [sr_t, es_t], ids=["srgan", "esrgan"])
def test_steps_per_dispatch_prints_the_notice_and_runs_per_step(tmp_path, mod, capsys):
    """Neither trainer fuses (nor does the JAX package's): with
    ``--steps_per_dispatch 3`` each prints the notice and writes a row a
    batch."""
    argv = ["--synthetic_data", "--batch_size", str(B), "--hr_height", str(HR), "--n_epochs",
            "1", "--max_batches", "4", "--sample_interval", "0", "--log_interval", "0",
            "--steps_per_dispatch", "3"]
    argv += ["--residual_blocks", "1", "--warmup_batches", "2"] if mod is es_t else []
    _, rows, _ = run_main(lambda a: mod.main(a, CPU), argv, tmp_path)
    assert "--steps_per_dispatch is not supported by this recipe" in capsys.readouterr().out
    assert [r["step"] for r in rows] == [0, 1, 2, 3]

