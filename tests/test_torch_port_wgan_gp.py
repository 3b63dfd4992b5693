"""The port's WGAN-GP slice against the JAX package, on the CPU: template-A
blocks, one d_step and the following g_step, the MNIST-class data path, the
flags and a short run of both trainers.

The JAX trainer (``tpugan.models.wgan_gp``) takes its default, generic
double-backward penalty. Its initial parameters and BatchNorm statistics go
into the port's modules through ``load_jax_params``; z and the penalty's
alpha are drawn on the JAX side from the d_step's own key splits
(``tpugan/models/_critic_family.py:66-67``) and passed to the port.

Tolerances, fp32 on both sides with sums in different orders:
- forwards: 1e-5 absolute on outputs of unit scale;
- d_loss and g_loss: 1e-5 relative;
- parameters and running statistics after the updates: 1e-3 relative and
  5e-5 absolute, the bound tests/test_pallas_critic.py:150-155 pins between
  the closed form and the generic penalty.
"""

import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

from tpugan.data import DeviceLoader as DeviceLoader_j
from tpugan.data.sources import mnist_or_synthetic as mnist_or_synthetic_j
from tpugan.models import _critic_family as cf_j
from tpugan.models import wgan_gp as wg_j
from tpugan.models._common import apply_mod
from tpugan_torch.data.loader import DeviceLoader
from tpugan_torch.data.sources import ArrayDataset, mnist_or_synthetic, resize_dataset
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import _critic_family as cf_t
from tpugan_torch.models import wgan_gp as wg_t
from tpugan_torch.nn.blocks import MLPDiscriminator, MLPGenerator
from tpugan_torch.nn.layers import BatchNorm1d, ConvTranspose2d, Linear

CPU = torch.device("cpu")
B, LATENT = 8, 16
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _cfg(mod, **kw):
    return mod.Config(batch_size=B, latent_dim=LATENT, synthetic_data=True, **kw)


def _imgs(seed=5):
    return np.random.default_rng(seed).integers(0, 255, (B, 28, 28, 1), np.uint8)


def _port_modules(params, model_state):
    G = MLPGenerator((1, 28, 28), LATENT)
    D = MLPDiscriminator(784, sigmoid=False)
    load_jax_params(G, params["generator"], model_state["generator"])
    load_jax_params(D, params["discriminator"])
    return {"generator": G, "discriminator": D}


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's initial state, its d_step and g_step on one batch,
    and the draws the d_step made."""
    os.environ.pop("TPUGAN_PALLAS_GP", None)  # the default, generic penalty
    cfg = _cfg(wg_j)
    mods = wg_j.build(cfg)
    state0 = wg_j.create_state(cfg, mods)
    d_step, g_step = wg_j.make_steps(cfg, mods)
    imgs = _imgs()
    _, k_z, k_pen = jax.random.split(state0.rng, 3)
    z = np.array(jax.random.normal(k_z, (B, LATENT)))
    alpha = np.array(jax.random.uniform(k_pen, (B, 1, 1, 1), jnp.float32))
    state1, d_out = jax.jit(d_step)(state0, imgs, np.zeros(B, np.int32))
    state2, g_out = jax.jit(g_step)(state1, d_out["z"])
    assert np.array_equal(np.asarray(d_out["z"]), z)
    return {
        "mods": mods, "imgs": imgs, "z": z, "alpha": alpha,
        "params0": _np_tree(state0.params), "stats0": _np_tree(state0.model_state),
        "params2": _np_tree(state2.params), "stats2": _np_tree(state2.model_state),
        "d_loss": float(d_out["d_loss"]), "g_loss": float(g_out["g_loss"]),
        "gen_imgs": np.asarray(g_out["gen_imgs"]),
    }


def _port_steps(jax_run, path, monkeypatch):
    if path == "generic":
        monkeypatch.setattr(wg_t, "extract_mlp_critic", lambda module: None)
    cfg = _cfg(wg_t)
    modules = _port_modules(jax_run["params0"], jax_run["stats0"])
    state = wg_t.create_state(cfg, modules, CPU)
    d_step, g_step = wg_t.make_steps(cfg, state)
    state, d_out = d_step(state, torch.from_numpy(jax_run["imgs"]), None,
                          z=torch.from_numpy(jax_run["z"]),
                          alpha=torch.from_numpy(jax_run["alpha"]))
    state, g_out = g_step(state, d_out["z"])
    return modules, d_out, g_out


@pytest.mark.parametrize("path", ["closed", "generic"])
def test_d_step_then_g_step_match_jax(jax_run, path, monkeypatch):
    modules, d_out, g_out = _port_steps(jax_run, path, monkeypatch)
    np.testing.assert_allclose(float(d_out["d_loss"]), jax_run["d_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(g_out["g_loss"]), jax_run["g_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g_out["gen_imgs"].numpy(), _nchw(jax_run["gen_imgs"]),
                               atol=1e-5)
    want = _port_modules(jax_run["params2"], jax_run["stats2"])
    for role in ("generator", "discriminator"):
        got_sd, want_sd = modules[role].state_dict(), want[role].state_dict()
        assert list(got_sd) == list(want_sd)
        for k in want_sd:
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"{path} {role} {k}")
    # Two G forwards in train mode: the d_step's and the g_step's.
    assert int(modules["generator"].model[3].num_batches_tracked) == 2


@pytest.mark.parametrize("train", [True, False])
def test_blocks_forward_matches_jax(jax_run, train):
    """G and D forwards with the JAX weights and BatchNorm statistics (those
    after two train-mode G forwards, so the running statistics are not the
    initial ones)."""
    mods = jax_run["mods"]
    params, stats = jax_run["params2"], jax_run["stats2"]
    z = np.random.default_rng(1).normal(size=(B, LATENT)).astype(np.float32)
    out_j, stats_j = apply_mod(mods["generator"], params["generator"], stats["generator"],
                               jnp.asarray(z), train=train)
    modules = _port_modules(params, stats)
    G, D = modules["generator"], modules["discriminator"]
    G.train(train)
    with torch.no_grad():
        out_t = G(torch.from_numpy(z))
        d_t = D(out_t)
    np.testing.assert_allclose(out_t.numpy(), _nchw(out_j), atol=1e-5)
    d_j, _ = apply_mod(mods["discriminator"], params["discriminator"], None, out_j)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    want = load_jax_params(MLPGenerator((1, 28, 28), LATENT), params["generator"],
                           _np_tree(stats_j)).state_dict()
    for k, v in G.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_load_jax_params_takes_batch_stats_and_needs_them(jax_run):
    G = MLPGenerator((1, 28, 28), LATENT)
    stats = jax_run["stats0"]["generator"]
    load_jax_params(G, jax_run["params0"]["generator"], stats)
    means = [v for k, v in G.state_dict().items() if k.endswith("running_mean")]
    assert [m.shape[0] for m in means] == [256, 512, 1024]
    assert int(G.model[3].num_batches_tracked) == 0
    with pytest.raises(ValueError, match="running_mean"):
        load_jax_params(MLPGenerator((1, 28, 28), LATENT), jax_run["params0"]["generator"])


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("source", ["synthetic", "idx"])
def test_mnist_or_synthetic_identical(tmp_path, source):
    if source == "idx":
        rng = np.random.default_rng(0)
        (tmp_path / "mnist").mkdir()
        _write_idx(tmp_path / "mnist" / "train-images-idx3-ubyte",
                   rng.integers(0, 256, (12, 28, 28)))
        _write_idx(tmp_path / "mnist" / "train-labels-idx1-ubyte", rng.integers(0, 10, 12))
    got, got_real = mnist_or_synthetic(str(tmp_path), synthetic_n=64, seed=3)
    want, want_real = mnist_or_synthetic_j(str(tmp_path), synthetic_n=64, seed=3)
    assert got_real == want_real == (source == "idx")
    assert got.images.dtype == np.uint8 and np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels)


def test_critic_family_loader_batches_identical():
    cfg_t, cfg_j = _cfg(wg_t, seed=2), _cfg(wg_j, seed=2)
    t_loader = cf_t.make_loader_a(cfg_t, CPU)
    j_loader = cf_j.make_loader_a(cfg_j)
    assert isinstance(j_loader, DeviceLoader_j) and isinstance(t_loader, DeviceLoader)
    assert len(t_loader) == len(j_loader) == 4096 // B
    for epoch in (0, 1):
        for n, (got, want) in enumerate(zip(t_loader.epoch(epoch), j_loader.epoch(epoch))):
            for g, w in zip(got, want):
                assert g.device == CPU and np.array_equal(g.numpy(), np.asarray(w))
            if n == 3:
                break


def test_resize_dataset_is_not_ported_beyond_identity():
    """At the dataset's own size the dataset comes back as it is; other
    sizes are resized (held to the JAX package in
    tests/test_torch_port_dcgan.py)."""
    ds = ArrayDataset(np.zeros((2, 28, 28, 1), np.uint8), np.zeros(2, np.int32))
    assert resize_dataset(ds, 28) is ds
    out = resize_dataset(ds, 32)
    assert out.images.shape == (2, 32, 32, 1) and not out.images.any()


def test_config_flags_match_jax():
    got = {f.name: (f.default, f.type) for f in dataclasses.fields(wg_t.Config)}
    want = {f.name: (f.default, f.type) for f in dataclasses.fields(wg_j.Config)}
    assert got == want


def test_layer_init_is_seeded_and_other_modes_raise():
    a = Linear(100, 128, generator=torch.Generator().manual_seed(0))
    b = Linear(100, 128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert float(a.weight.detach().abs().max()) <= 0.1
    assert float(a.bias.detach().abs().max()) <= 0.1
    bn = BatchNorm1d(256, 0.8)
    assert (bn.eps, bn.momentum) == (0.8, 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Linear(4, 4, init_mode="he")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ConvTranspose2d(4, 4, 3, init_mode="he")


def test_ten_batch_runs_write_the_same_samples(tmp_path):
    argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", "10", "--batch_size", "16",
            "--latent_dim", "16", "--sample_interval", "5", "--log_interval", "5"]
    for name, main in (("jax", lambda a: wg_j.main(a)), ("port", lambda a: wg_t.main(a, CPU))):
        out = tmp_path / name
        main(argv + ["--output_dir", str(out), "--metrics_jsonl", str(out / "m.jsonl")])
    names = {n: sorted(os.listdir(tmp_path / n / "images")) for n in ("jax", "port")}
    assert names["port"] == names["jax"] == ["0.png", "5.png"]
    rows = {n: (tmp_path / n / "m.jsonl").read_text().splitlines() for n in ("jax", "port")}
    assert len(rows["port"]) == len(rows["jax"]) == 10
    for name in names["port"]:
        assert (tmp_path / "port" / "images" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_run_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        wg_t.main(["--synthetic_data", "--output_dir", str(tmp_path)])


def test_cli_lists_wgan_gp(capsys):
    from tpugan_torch.__main__ import main

    assert main(["list"]) == 0
    assert "wgan_gp" in capsys.readouterr().out
