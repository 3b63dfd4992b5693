"""The port's template-B slice (DCGAN and LSGAN) against the JAX package, on
the CPU at img_size 16 and 32, batch 8, latent 16.

The JAX trainers (``tpugan.models.dcgan``/``lsgan``) are built once per
module, and one jitted function gives both their training step and the
gradients that step applies (recomputed with its loss functions). Their
initial parameters and BatchNorm statistics go into the port's modules
through ``load_jax_params``. z is drawn on the JAX side from the step's own
key split (``tpugan/models/_template_b.py:51-52``); the Dropout2d keep masks
of the discriminator's three forwards are read off the JAX discriminator
applied with each forward's dropout key and ``capture_intermediates`` on its
Dropout2d modules (a channel is kept where its output is not all zero).
Both are passed to the port.

Tolerances, float32 on both sides with sums in different orders:
- forwards and generated images: 1e-5 absolute on outputs of unit scale;
- BatchNorm input gradients: 1e-5 absolute; running statistics: 1e-5
  relative and 1e-6 absolute;
- bce: 1e-6 relative on the loss, 1e-5 relative on its gradient;
- the two losses of a step: 1e-5 relative;
- gradients: 1e-3 relative, plus 1e-4 of the largest gradient of that
  module absolute (a conv bias that feeds a BatchNorm has a true gradient of
  0, so what both sides hold there is rounding noise);
- parameters after Adam: 1e-5 absolute where the gradient is above that
  noise floor, and 2*lr elsewhere (Adam's first step is lr*g/(|g|+eps),
  which turns the noise of a zero gradient into +-lr);
- running statistics after the step: 1e-4 relative and 1e-6 absolute;
- resize_dataset: byte-identical when enlarging; when shrinking, JAX's
  float result and the port's may round apart by 1 level only where JAX's
  float lies within 1e-4 of an integer (truncation to uint8).
"""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

from tpugan.data.sources import ArrayDataset as ArrayDataset_j
from tpugan.data.sources import resize_dataset as resize_dataset_j
from tpugan.losses import bce as bce_j
from tpugan.losses import mse as mse_j
from tpugan.models import dcgan as dc_j
from tpugan.models import lsgan as ls_j
from tpugan.models._common import apply_mod
from tpugan.nn.layers import BatchNorm as BatchNorm_j
from tpugan.nn.layers import Dropout2d as Dropout2d_j
from tpugan.train.state import normalize_uint8 as normalize_j
from tpugan_torch import bench
from tpugan_torch.data.sources import ArrayDataset, resize_dataset
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.losses import bce
from tpugan_torch.models import dcgan as dc_t
from tpugan_torch.models import lsgan as ls_t
from tpugan_torch.nn.layers import BatchNorm1d, BatchNorm2d, Dropout2d

CPU = torch.device("cpu")
B, LATENT = 8, 16
PARAM_ATOL = 1e-5
# (name, JAX module, port module, adversarial loss, img_size)
MODELS = {"dcgan": (dc_j, dc_t, bce_j, 32), "lsgan": (ls_j, ls_t, mse_j, 16)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _cfg(mod, img_size, **kw):
    return mod.Config(img_size=img_size, batch_size=B, latent_dim=LATENT, synthetic_data=True,
                      **kw)


def _jax_masks(D, params, stats, key, shape):
    """The Dropout2d keep masks the JAX discriminator draws with ``key``, as
    (B, C, 1, 1) float32 arrays in call order. They depend on the key and
    the shapes only, so a random input of the step's shape reads them."""
    x = jnp.asarray(np.random.default_rng(9).normal(size=shape).astype(np.float32))
    _, mut = D.apply({"params": params, "batch_stats": stats}, x, train=True,
                     rngs={"dropout": key}, mutable=["batch_stats", "intermediates"],
                     capture_intermediates=lambda m, _: isinstance(m, Dropout2d_j))
    outs = [v["__call__"][0] for v in mut["intermediates"]["DCGANTrunk_0"].values()]
    return [np.any(np.asarray(o) != 0, axis=(1, 2)).astype(np.float32)[:, :, None, None]
            for o in outs]


def _jax_grads(cfg, mods, state, imgs, adv):
    """The gradients the JAX step applies, from its loss functions
    (tpugan/models/_template_b.py:49-95)."""
    G, D = mods["generator"], mods["discriminator"]
    params, ms = state.params, state.model_state
    _, k_z, k1, k2, k3 = jax.random.split(state.rng, 5)
    z = jax.random.normal(k_z, (imgs.shape[0], cfg.latent_dim))
    real = normalize_j(imgs)

    def g_loss_fn(g_params):
        gen, _ = apply_mod(G, g_params, ms["generator"], z, train=True)
        d_out, _ = apply_mod(D, params["discriminator"], ms["discriminator"], gen, train=True,
                             dropout_rng=k1)
        return adv(d_out, 1.0), gen

    (_, gen), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(params["generator"])
    fake = jax.lax.stop_gradient(gen)

    def d_loss_fn(d_params):
        d_real, _ = apply_mod(D, d_params, ms["discriminator"], real, train=True, dropout_rng=k2)
        d_fake, _ = apply_mod(D, d_params, ms["discriminator"], fake, train=True, dropout_rng=k3)
        return 0.5 * (adv(d_real, 1.0) + adv(d_fake, 0.0))

    return {"generator": g_grads, "discriminator": jax.grad(d_loss_fn)(params["discriminator"])}


def _port_modules(mod_t, cfg, params, stats):
    modules = mod_t.build(cfg, CPU)
    for role in ("generator", "discriminator"):
        load_jax_params(modules[role], params[role], stats[role])
    return modules


def _as_torch(mod_t, cfg, params, stats):
    """A JAX tree in the port's layout, by state_dict key."""
    mods = _port_modules(mod_t, cfg, params, stats)
    return {role: {k: v.clone() for k, v in m.state_dict().items()} for role, m in mods.items()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def ref(request):
    """One JAX step and its gradients, and the same step of the port from
    the same weights, z and masks."""
    name = request.param
    mod_j, mod_t, adv, size = MODELS[name]
    cfg_j, cfg_t = _cfg(mod_j, size), _cfg(mod_t, size)
    mods = mod_j.build(cfg_j)
    state0 = mod_j.create_state(cfg_j, mods)
    imgs = np.random.default_rng(5).integers(0, 256, (B, size, size, 1), dtype=np.uint8)
    step = mod_j.make_step(cfg_j, mods)

    def step_and_grads(s, x):
        new_state, out = step(s, x, jnp.zeros(B, jnp.int32))
        return new_state, out, _jax_grads(cfg_j, mods, s, x, adv)

    state1, out, grads = jax.jit(step_and_grads)(state0, imgs)
    _, k_z, *k_do = jax.random.split(state0.rng, 5)
    D = mods["discriminator"]
    params0, stats0 = _np(state0.params), _np(state0.model_state)
    masks = [_jax_masks(D, params0["discriminator"], stats0["discriminator"], k, imgs.shape)
             for k in k_do]
    z = np.array(jax.random.normal(k_z, (B, LATENT)))

    modules = _port_modules(mod_t, cfg_t, params0, stats0)
    state = mod_t.create_state(cfg_t, modules, CPU)
    state, out_t = mod_t.make_step(cfg_t, state)(
        state, torch.from_numpy(imgs), None, z=torch.from_numpy(z),
        masks=[[torch.from_numpy(m) for m in ms] for ms in masks])
    return {
        "name": name, "mod_j": mod_j, "mod_t": mod_t, "cfg_j": cfg_j, "cfg_t": cfg_t,
        "mods": mods, "size": size, "masks": masks, "z": z, "k_do": k_do,
        "params0": params0, "stats0": stats0,
        "params1": _np(state1.params), "stats1": _np(state1.model_state),
        "grads": _np(grads), "out": {k: np.asarray(v) for k, v in out.items()},
        "modules": modules, "out_t": out_t,
    }


def test_jax_masks_keep_three_quarters(ref):
    kept = np.concatenate([m.ravel() for ms in ref["masks"] for m in ms])
    assert kept.size == 3 * B * (16 + 32 + 64 + 128)
    assert 0.7 < kept.mean() < 0.8
    assert not np.array_equal(ref["masks"][0][3], ref["masks"][1][3])


def test_step_losses_and_images_match_jax(ref):
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(ref["out_t"][k]), float(ref["out"][k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(ref["out_t"]["gen_imgs"].numpy(), _nchw(ref["out"]["gen_imgs"]),
                               atol=1e-5)


@pytest.mark.parametrize("role", ["generator", "discriminator"])
def test_step_gradients_match_jax(ref, role):
    """After the step each parameter's ``.grad`` holds what it was updated
    with: G's from the G phase, D's from the D phase alone."""
    want = _as_torch(ref["mod_t"], ref["cfg_t"], ref["grads"], ref["stats0"])[role]
    grads = {k: p.grad for k, p in ref["modules"][role].named_parameters()}
    floor = 1e-4 * max(float(g.abs().max()) for g in want.values() if g.dtype.is_floating_point)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-3, atol=floor, err_msg=k)


@pytest.mark.parametrize("role", ["generator", "discriminator"])
def test_step_params_and_running_stats_match_jax(ref, role):
    """Every updated parameter, and every BatchNorm running statistic: G's
    after one forward, D's after three, in the reference's order. Each
    parameter is Adam's first step of the port's own gradient, and agrees
    with JAX's where JAX's gradient is above the noise floor."""
    cfg = ref["cfg_t"]
    want = _as_torch(ref["mod_t"], cfg, ref["params1"], ref["stats1"])[role]
    grads = _as_torch(ref["mod_t"], cfg, ref["grads"], ref["stats0"])[role]
    got = ref["modules"][role].state_dict()
    assert list(got) == list(want)
    before = _as_torch(ref["mod_t"], cfg, ref["params0"], ref["stats0"])[role]
    own = {k: p.grad for k, p in ref["modules"][role].named_parameters()}
    noise = 1e-4 * max(float(grads[k].abs().max()) for k in own)
    n_forwards = 1 if role == "generator" else 3
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == n_forwards, k
        elif "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        else:
            torch.testing.assert_close(v, _adam_first_step(before[k], own[k], cfg), rtol=1e-6,
                                       atol=1e-7, msg=lambda m: f"{k}: {m}")
            diff = (v - want[k]).abs()
            settled = grads[k].abs() > noise
            if settled.any():
                assert float(diff[settled].max()) <= PARAM_ATOL, k


def _adam_first_step(p0, g, cfg, eps=1e-8):
    """torch.optim.Adam's first update from ``p0`` with gradient ``g``: the
    bias-corrected moments are g and g**2, so the step is lr * g / (|g| + eps)."""
    g = g.double()
    return (p0.double() - cfg.lr * g / (g.abs() + eps)).float()


def test_step_draws_z_then_masks_from_the_state_generator(ref):
    cfg, mod_t = ref["cfg_t"], ref["mod_t"]
    modules = mod_t.build(cfg, CPU)
    state = mod_t.create_state(cfg, modules, CPU)
    want = torch.Generator().manual_seed(cfg.seed)
    z = torch.randn(B, LATENT, generator=want)
    masks = [modules["discriminator"].draw_masks(B, want) for _ in range(3)]
    seen = []
    g_forward = modules["generator"].forward
    modules["generator"].forward = lambda zz: seen.append(zz.clone()) or g_forward(zz)
    d_forward = modules["discriminator"].forward
    modules["discriminator"].forward = lambda x, m=None: seen.append(m) or d_forward(x, m)
    imgs = torch.from_numpy(np.zeros((B, ref["size"], ref["size"], 1), np.uint8))
    mod_t.make_step(cfg, state)(state, imgs)
    assert torch.equal(seen[0], z)
    for got, drawn in zip(seen[1:], masks):
        assert all(torch.equal(a, b) for a, b in zip(got, drawn))
    assert torch.equal(state.draws.get_state(), want.get_state())
    assert state.step == 1


@pytest.mark.parametrize("train", [True, False])
def test_forwards_match_jax_after_load_jax_params(ref, train):
    """G and D with the weights and BatchNorm statistics after the JAX step
    (so the running statistics are not the initial ones); in training D
    takes the first forward's masks."""
    mods, params, stats = ref["mods"], ref["params1"], ref["stats1"]
    modules = _port_modules(ref["mod_t"], ref["cfg_t"], params, stats)
    G, D = modules["generator"], modules["discriminator"]
    for role, m in modules.items():
        for k, v in m.state_dict().items():
            if "running" in k:
                assert float(v.abs().sum()) > 0, k
    G.train(train)
    D.train(train)
    z = np.random.default_rng(1).normal(size=(B, LATENT)).astype(np.float32)
    out_j, _ = apply_mod(mods["generator"], params["generator"], stats["generator"],
                         jnp.asarray(z), train=train)
    masks = [torch.from_numpy(m) for m in ref["masks"][0]] if train else None
    with torch.no_grad():
        out_t = G(torch.from_numpy(z))
        d_t = D(out_t, masks)
    np.testing.assert_allclose(out_t.numpy(), _nchw(out_j), atol=1e-5)
    d_j, _ = apply_mod(mods["discriminator"], params["discriminator"], stats["discriminator"],
                       out_j, train=train, dropout_rng=ref["k_do"][0] if train else None)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)


def test_state_dict_keys_are_the_reference_layout(ref):
    """dcgan/dcgan.py:45-99 and lsgan/lsgan.py:45-99: ``l1``,
    ``conv_blocks`` (lsgan without the first BatchNorm), ``model`` and
    ``adv_layer``, numbered as their ``nn.Sequential``s."""
    bn = lambda p: [f"{p}.weight", f"{p}.bias", f"{p}.running_mean", f"{p}.running_var",
                    f"{p}.num_batches_tracked"]
    wb = lambda p: [f"{p}.weight", f"{p}.bias"]
    if ref["name"] == "dcgan":
        g = (wb("l1.0") + bn("conv_blocks.0") + wb("conv_blocks.2") + bn("conv_blocks.3")
             + wb("conv_blocks.6") + bn("conv_blocks.7") + wb("conv_blocks.9"))
    else:
        g = (wb("l1.0") + wb("conv_blocks.1") + bn("conv_blocks.2") + wb("conv_blocks.5")
             + bn("conv_blocks.6") + wb("conv_blocks.8"))
    d = (wb("model.0") + wb("model.3") + bn("model.6") + wb("model.7") + bn("model.10")
         + wb("model.11") + bn("model.14") + wb("adv_layer.0"))
    assert list(ref["modules"]["generator"].state_dict()) == g
    assert list(ref["modules"]["discriminator"].state_dict()) == d
    head = ref["modules"]["discriminator"].adv_layer
    assert isinstance(head[-1], torch.nn.Sigmoid) == (ref["name"] == "dcgan")


@pytest.mark.parametrize("eps", [1e-5, 0.8])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm2d_matches_jax(eps, train):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 5, 6, 3)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    bn_j = BatchNorm_j(eps=eps, init_mode="normal02")
    variables = bn_j.init(jax.random.PRNGKey(3), jnp.asarray(x), train=True)
    stats = jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])

    def f(xx):
        y, mut = bn_j.apply({"params": variables["params"], "batch_stats": stats}, xx,
                            train=train, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), dx_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    bn_t = BatchNorm2d(3, eps)
    load_jax_params(bn_t, _np(variables["params"]), _np(stats))
    bn_t.train(train)
    xt = torch.from_numpy(_nchw(x).copy()).requires_grad_()
    y_t = bn_t(xt)
    (y_t * torch.from_numpy(_nchw(g).copy())).sum().backward()
    assert (bn_t.eps, bn_t.momentum) == (eps, 0.1)
    np.testing.assert_allclose(y_t.detach().numpy(), _nchw(y_j), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _nchw(dx_j), atol=1e-5)
    np.testing.assert_allclose(bn_t.running_mean.numpy(), np.asarray(stats_j["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn_t.running_var.numpy(), np.asarray(stats_j["var"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", [BatchNorm1d, BatchNorm2d])
def test_batchnorm_init_modes(cls):
    gen = lambda: torch.Generator().manual_seed(0)
    a, b = cls(4096, init_mode="normal02", generator=gen()), cls(4096, init_mode="normal02",
                                                                generator=gen())
    w = a.weight.detach()
    assert torch.equal(w, b.weight) and not a.bias.detach().any()
    assert abs(float(w.mean()) - 1.0) < 2e-3 and abs(float(w.std()) - 0.02) < 2e-3
    t = cls(8)
    assert torch.equal(t.weight, torch.ones(8)) and torch.equal(t.bias, torch.zeros(8))
    with pytest.raises(ValueError, match="normal02"):
        cls(4, init_mode="he")


def test_dropout2d_with_an_injected_mask_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 5, 5, 7)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    drop = Dropout2d_j(0.25)

    def f(xx):
        y = drop.apply({}, xx, train=True, rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(y * g), y

    (_, y_j), dx_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    mask = np.any(np.asarray(y_j) != 0, axis=(1, 2)).astype(np.float32)[:, :, None, None]
    assert 0 < mask.mean() < 1
    d = Dropout2d(0.25)
    xt = torch.from_numpy(_nchw(x).copy()).requires_grad_()
    y_t = d(xt, torch.from_numpy(mask))
    (y_t * torch.from_numpy(_nchw(g).copy())).sum().backward()
    np.testing.assert_array_equal(y_t.detach().numpy(), _nchw(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(), _nchw(dx_j))
    d.eval()
    assert d(xt) is xt
    y_e = fnn.Dropout(0.25, broadcast_dims=(1, 2), deterministic=True).apply({}, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y_e), x)


def test_dropout2d_draws_from_its_generator_only():
    d = Dropout2d(0.25)
    x = torch.ones(64, 128, 2, 2)
    with pytest.raises(ValueError, match="mask"):
        d(x)
    torch.manual_seed(0)
    global_state = torch.get_rng_state()
    y1, y2 = (d(x, d.draw_mask((64, 128, 1, 1), torch.Generator().manual_seed(3)))
              for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(torch.get_rng_state(), global_state)
    kept = (y1[:, :, 0, 0] != 0).float()
    assert 0.72 < float(kept.mean()) < 0.78
    assert torch.equal(y1, kept[:, :, None, None].expand_as(x) / 0.75)


def test_bce_matches_jax():
    p = np.array([0.0, 1.0, 1e-30, 0.3, 0.5, 0.999999, 0.9], np.float32).reshape(-1, 1)
    for target in (0.0, 1.0):
        np.testing.assert_allclose(float(bce(torch.from_numpy(p), target)),
                                   float(bce_j(jnp.asarray(p), target)), rtol=1e-6)
        q = p[3:5]
        pt = torch.from_numpy(q.copy()).requires_grad_()
        bce(pt, target).backward()
        want = jax.grad(lambda v: bce_j(v, target))(jnp.asarray(q))
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-5)
    assert float(bce(torch.zeros(3, 1), 1.0)) == 100.0


@pytest.mark.parametrize("size", [32, 64, 16])
@pytest.mark.parametrize("source", ["uniform", "glyphs"])
def test_resize_dataset_matches_jax(size, source):
    from tpugan_torch.data.sources import synthetic_image_dataset

    if source == "uniform":
        imgs = np.random.default_rng(6).integers(0, 256, (24, 28, 28, 1), dtype=np.uint8)
    else:
        imgs = synthetic_image_dataset(24, 28, seed=6).images
    labels = np.arange(24, dtype=np.int32)
    got = resize_dataset(ArrayDataset(imgs, labels), size)
    want = resize_dataset_j(ArrayDataset_j(imgs, labels), size)
    assert got.images.shape == (24, size, size, 1) and got.images.dtype == np.uint8
    assert got.labels is labels
    if size > 28:
        np.testing.assert_array_equal(got.images, want.images)
        return
    exact = np.asarray(jax.image.resize(imgs.astype(np.float32), (24, size, size, 1),
                                        "bilinear"))
    differ = got.images != want.images
    near_integer = np.abs(exact - np.round(exact)) <= 1e-4
    assert not (differ & ~near_integer).any()
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_flags_match_jax(name):
    mod_j, mod_t = MODELS[name][:2]
    got = {f.name: (f.default, f.type) for f in dataclasses.fields(mod_t.Config)}
    want = {f.name: (f.default, f.type) for f in dataclasses.fields(mod_j.Config)}
    assert got == want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_few_batch_main_writes_the_samples(tmp_path, name, capsys):
    """``--max_batches``, ``--log_interval``, ``--sample_interval`` and
    ``--metrics_jsonl`` as the JAX trainer takes them: the same sample
    files, logged batches and metric rows."""
    mod_j, mod_t, _, size = MODELS[name]
    argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", "5", "--batch_size", "8",
            "--latent_dim", "16", "--img_size", str(size), "--sample_interval", "3",
            "--log_interval", "2"]
    logged = {}
    for side, main in (("jax", mod_j.main), ("port", lambda a: mod_t.main(a, CPU))):
        out = tmp_path / side
        main(argv + ["--output_dir", str(out), "--metrics_jsonl", str(out / "m.jsonl")])
        logged[side] = [line.split("] [D loss")[0] for line in capsys.readouterr().out.splitlines()
                        if line.startswith("[Epoch")]
    assert logged["port"] == logged["jax"] == [f"[Epoch 0/1] [Batch {i}/5" for i in (0, 2, 4)]
    assert sorted(os.listdir(tmp_path / "jax" / "images")) == ["0.png", "3.png"]
    port = tmp_path / "port"
    assert sorted(os.listdir(port / "images")) == ["0.png", "3.png"]
    for png in ("0.png", "3.png"):
        head = (port / "images" / png).read_bytes()[:24]
        # The batch's 8 images (of the first 25), 5 a row, padding 2.
        assert head[:8] == b"\x89PNG\r\n\x1a\n"
        assert (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")) == (
            5 * (size + 2) + 2, 2 * (size + 2) + 2)
    rows = {side: [json.loads(line) for line in (tmp_path / side / "m.jsonl").read_text()
                   .splitlines()] for side in ("jax", "port")}
    for side_rows in rows.values():
        assert [r["step"] for r in side_rows] == list(range(5))
        assert all(set(r) == {"step", "d_loss", "g_loss"} for r in side_rows)
    assert all(np.isfinite([r["d_loss"], r["g_loss"]]).all() for r in rows["port"])


def test_steps_per_dispatch_prints_the_notice_and_runs_per_step(tmp_path, capsys):
    """The notice belongs to the loops that do not fuse (the im2im loops'
    ``StepObserver(cfg)``); DCGAN's loop fuses and prints none. With fewer
    batches than K, its epoch is all tail: one step at a time."""
    from tpugan_torch.train.loop import StepObserver

    cfg = dc_t.Config(steps_per_dispatch=4)
    StepObserver(cfg)
    assert "--steps_per_dispatch is not supported" in capsys.readouterr().out
    dc_t.main(["--synthetic_data", "--n_epochs", "1", "--max_batches", "2", "--batch_size", "8",
               "--latent_dim", "16", "--img_size", "16", "--steps_per_dispatch", "4",
               "--sample_interval", "0", "--output_dir", str(tmp_path)], CPU)
    out = capsys.readouterr().out
    assert "--steps_per_dispatch is not supported" not in out
    assert sum(line.startswith("[Epoch 0/1] [Batch") for line in out.splitlines()) == 2


def test_bench_runs_at_a_tiny_size_on_the_cpu():
    rec = json.loads(json.dumps(bench.measure(16, 4, 2, CPU)))
    assert (rec["img_size"], rec["batch_size"], rec["steps_per_dispatch"]) == (16, 4, 2)
    assert rec["unit"] == "images/sec/cpu" and rec["device"] == "cpu"
    assert rec["mode"] == "python_loop" and rec["capture_s"] is None
    assert rec["card"] is None and rec["dtype"] == "float32" and rec["value"] > 0
    assert all(np.isfinite(list(rec["losses"].values())))


@pytest.mark.parametrize("main", [dc_t.main, ls_t.main, bench.main])
def test_runs_raise_without_cuda(tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if main is bench.main:
            main()
        else:
            main(["--synthetic_data", "--output_dir", str(tmp_path)])


def test_cli_lists_every_ported_trainer(capsys):
    from tpugan_torch.__main__ import main

    assert main(["list"]) == 0
    names = capsys.readouterr().out.split()
    assert {"cyclegan", "dcgan", "lsgan", "munit", "wgan", "wgan_gp"} <= set(names)
