"""The port's conditional family, cgan, acgan, sgan and infogan, and the
layers, losses and interop it brings (Embedding, Dropout, the cross-entropy
losses, ``load_jax_params`` on embedding tables), against the JAX package on
the CPU at img_size 16, batch 8, latent 16.

One step of each trainer goes against one ``jax.jit`` of the JAX step, with
the harness of ``tests/test_torch_port_critic_rest.py``: the same weights
through ``load_jax_params``; the JAX step's z, labels and codes read off its
own key splits, and the Dropout and Dropout2d keep masks off the JAX
discriminator with ``capture_intermediates``, all passed in; the gradients
each optimizer applies recorded on both sides (infogan's three: G's, D's and
the information phase's over both). Tolerances are that file's: losses 1e-5
relative, images 1e-5 absolute, gradients 1e-3 relative plus 1e-4 of the
module's largest, each update Adam's first step of the port's own gradient
(1e-6 relative, 1e-7 absolute) and within 1e-5 of JAX's where settled,
running statistics 1e-4 relative and 1e-6 absolute. The discriminator's
accuracy (acgan, sgan) is an argmax count: equal. The layers: Embedding and
Dropout outputs and gradients bit for bit; the losses 1e-6 relative, their
gradients 1e-5 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import (
    B,
    CPU,
    LATENT,
    SIZE,
    Spec,
    check_gradients,
    check_losses_and_images,
    check_params,
    check_running_stats,
    make_ref,
    nchw,
    np_tree,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    png_size,
    run_main,
    t,
)

from tpugan.losses import cross_entropy_logits as cross_entropy_logits_j
from tpugan.losses import cross_entropy_on_softmax as cross_entropy_on_softmax_j
from tpugan.models import acgan as ac_j
from tpugan.models import cgan as cg_j
from tpugan.models import infogan as ig_j
from tpugan.models import sgan as sg_j
from tpugan.nn.layers import Dropout as Dropout_j
from tpugan.nn.layers import Embedding as Embedding_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.losses import cross_entropy_logits, cross_entropy_on_softmax
from tpugan_torch.models import acgan as ac_t
from tpugan_torch.models import cgan as cg_t
from tpugan_torch.models import infogan as ig_t
from tpugan_torch.models import sgan as sg_t
from tpugan_torch.nn.layers import Dropout, Embedding

TRAINERS = {"acgan": (ac_j, ac_t), "cgan": (cg_j, cg_t), "infogan": (ig_j, ig_t),
            "sgan": (sg_j, sg_t)}


def _labels(key, cfg, b):
    return t(jax.random.randint(key, (b,), 0, cfg.n_classes), np.int64)


def _draws_labelled(rng, cfg, shape):
    """cgan and acgan (``tpugan/models/cgan.py:124-127``)."""
    _, k_z, k_lbl, k1, k2, k3 = jax.random.split(rng, 6)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim))),
            "gen_labels": _labels(k_lbl, cfg, shape[0])}, [k1, k2, k3]


def _draws_sgan(rng, cfg, shape):
    _, k_z, k1, k2, k3 = jax.random.split(rng, 5)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim)))}, [k1, k2, k3]


def _draws_infogan(rng, cfg, shape):
    """``tpugan/models/infogan.py:124-137,191-196``."""
    b = shape[0]
    _, k_z1, k_l1, k_c1, k_z2, k_l2, k_c2, k1, k2, k3, k4 = jax.random.split(rng, 11)
    code = lambda k: t(jax.random.uniform(k, (b, cfg.code_dim), minval=-1.0, maxval=1.0))
    return {"z": t(jax.random.normal(k_z1, (b, cfg.latent_dim))),
            "gen_labels": _labels(k_l1, cfg, b), "code": code(k_c1),
            "info_z": t(jax.random.normal(k_z2, (b, cfg.latent_dim))),
            "info_labels": _labels(k_l2, cfg, b), "info_code": code(k_c2)}, [k1, k2, k3, k4]


SPECS = {
    "cgan": Spec(cg_j, cg_t, _draws_labelled, {"generator": 1},
                 d_args=(jnp.zeros(B, jnp.int32),)),
    "acgan": Spec(ac_j, ac_t, _draws_labelled, {"generator": 1, "discriminator": 3}),
    "sgan": Spec(sg_j, sg_t, _draws_sgan, {"generator": 1, "discriminator": 3}),
    "infogan": Spec(ig_j, ig_t, _draws_infogan, {"generator": 2, "discriminator": 4}),
}
LOSSES = {"cgan": ("d_loss", "g_loss"), "acgan": ("d_loss", "g_loss"),
          "sgan": ("d_loss", "g_loss"), "infogan": ("d_loss", "g_loss", "info_loss")}


@pytest.fixture(scope="module", params=sorted(SPECS))
def ref(request):
    r = make_ref(SPECS[request.param])
    r["name"] = request.param
    return r


def test_step_losses_and_images_match_jax(ref):
    check_losses_and_images(ref, LOSSES[ref["name"]])
    if "d_acc" in ref["out"]:
        assert ref["out_t"]["d_acc"].dim() == 0
        assert float(ref["out_t"]["d_acc"]) == float(ref["out"]["d_acc"])


def test_step_gradients_match_jax(ref):
    """Every optimizer's gradients: infogan's information phase over both
    modules, where D's adversarial head takes none (JAX's are zero)."""
    check_gradients(ref)
    if ref["name"] == "infogan":
        info = ref["rec"]["info"][0]
        assert {r for r, _ in info} == {"generator", "discriminator"}
        assert info["discriminator", "adv_layer.0.weight"][1] is None
        assert info["generator", "l1.0.weight"][1] is not None


def test_step_params_match_jax(ref):
    check_params(ref)


def test_step_running_stats_match_jax(ref):
    """G's after its forwards (infogan: two), D's after three (infogan:
    four); cgan's D has no BatchNorm."""
    check_running_stats(ref)


def test_infogan_info_optimizer_holds_its_own_moments():
    """``tests/test_conditional_family.py:31-42`` on the port: three Adams,
    the third over both modules' parameters, with state of its own."""
    cfg = ig_t.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE, synthetic_data=True)
    state = ig_t.create_state(cfg, ig_t.build(cfg, CPU), CPU)
    assert set(state.optimizers) == {"generator", "discriminator", "info"}
    opt = state.optimizers
    info = [p for g in opt["info"].param_groups for p in g["params"]]
    g_d = [p for name in ("generator", "discriminator")
           for g in opt[name].param_groups for p in g["params"]]
    assert [id(p) for p in info] == [id(p) for p in g_d]
    step = ig_t.make_step(cfg, state)
    imgs = torch.zeros(B, SIZE, SIZE, 1, dtype=torch.uint8)
    state, _ = step(state, imgs, torch.zeros(B, dtype=torch.int32))
    p = info[0]
    m_info, m_g = opt["info"].state[p]["exp_avg"], opt["generator"].state[p]["exp_avg"]
    assert m_info is not m_g and not torch.equal(m_info, m_g)


@pytest.mark.parametrize("name", ["cgan", "acgan", "infogan"])
def test_step_draws_from_the_state_generator_in_the_documented_order(name):
    """z, labels, codes, then the masks, from ``state.draws``; infogan's
    information phase draws its own z, labels and code after the G phase's."""
    mod = TRAINERS[name][1]
    cfg = mod.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE, synthetic_data=True)
    modules = mod.build(cfg, CPU)
    state = mod.create_state(cfg, modules, CPU)
    D = modules["discriminator"]
    g = torch.Generator().manual_seed(cfg.seed)
    want = []  # (z, labels, code) a G forward
    for _ in range(2 if name == "infogan" else 1):
        z = torch.randn(B, LATENT, generator=g)
        labels = torch.randint(0, cfg.n_classes, (B,), generator=g)
        code = torch.rand(B, cfg.code_dim, generator=g) * 2 - 1 if name == "infogan" else None
        want.append((z, labels, code))
    masks = [D.draw_masks(B, g) for _ in range(4 if name == "infogan" else 3)]
    seen = []
    forward = modules["generator"].forward

    def spy(z, *args):
        seen.append((z, args))
        return forward(z, *args)

    modules["generator"].forward = spy
    imgs = torch.zeros(B, SIZE, SIZE, 1, dtype=torch.uint8)
    mod.make_step(cfg, state)(state, imgs, torch.zeros(B, dtype=torch.int32))
    assert torch.equal(state.draws.get_state(), g.get_state())
    assert len(seen) == len(want)
    for (z, args), (wz, labels, code) in zip(seen, want):
        assert torch.equal(z, wz)
        if name == "infogan":
            assert torch.equal(args[0], ig_t.to_categorical(labels, cfg.n_classes))
            assert torch.equal(args[1], code)
        else:
            assert torch.equal(args[0], labels)
    assert len(masks[0]) == (2 if name == "cgan" else 4)


def test_to_categorical_matches_jax_without_reading_the_labels_on_the_host():
    labels = torch.tensor([3, 0, 9, 9, 1])
    want = np.asarray(ig_j.to_categorical(labels.numpy(), 10))
    got = ig_t.to_categorical(labels, 10)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert ig_t.to_categorical(torch.tensor([0, 1]), 4).shape == (2, 4)


# --- Layers, losses, interop ---------------------------------------------------


def test_embedding_is_seeded_normal_and_matches_flax():
    gen = lambda: torch.Generator().manual_seed(0)
    a, b = Embedding(1000, 64, generator=gen()), Embedding(1000, 64, generator=gen())
    w = a.weight.detach()
    assert torch.equal(w, b.weight) and abs(float(w.mean())) < 0.01
    assert abs(float(w.std()) - 1.0) < 0.01
    emb_j = Embedding_j(10, 6)
    idx = np.array([[3, 0], [9, 3]], np.int32)
    variables = emb_j.init(jax.random.PRNGKey(0), jnp.asarray(idx))
    e = Embedding(10, 6)
    load_jax_params(e, np_tree(variables["params"]))
    assert np.array_equal(e.weight.detach().numpy(),
                          np.asarray(variables["params"]["Embed_0"]["embedding"]))
    g = np.random.default_rng(0).normal(size=(2, 2, 6)).astype(np.float32)

    def f(params):
        y = emb_j.apply({"params": params}, jnp.asarray(idx))
        return jnp.sum(y * g), y

    (_, y_j), grads_j = jax.value_and_grad(f, has_aux=True)(variables["params"])
    y = e(t(idx, np.int64))
    (y * t(g)).sum().backward()
    assert np.array_equal(y.detach().numpy(), np.asarray(y_j))
    assert np.array_equal(e.weight.grad.numpy(), np.asarray(grads_j["Embed_0"]["embedding"]))


def test_dropout_with_an_injected_mask_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    drop = Dropout_j(0.4)

    def f(xx):
        y = drop.apply({}, xx, train=True, rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(y * g), y

    (_, y_j), dx_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    mask = (np.asarray(y_j) != 0).astype(np.float32)
    assert 0.5 < mask.mean() < 0.7
    d = Dropout(0.4)
    xt = t(x).requires_grad_()
    y = d(xt, t(mask))
    (y * t(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_j))
    d.eval()
    assert d(xt) is xt


def test_dropout_draws_element_masks_from_its_generator_only():
    d = Dropout(0.4)
    x = torch.ones(256, 512)
    with pytest.raises(ValueError, match="Dropout in training needs its keep mask"):
        d(x)
    torch.manual_seed(0)
    global_state = torch.get_rng_state()
    y1, y2 = (d(x, d.draw_mask((256, 512), torch.Generator().manual_seed(3))) for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(torch.get_rng_state(), global_state)
    kept = (y1 != 0).float()
    assert 0.58 < float(kept.mean()) < 0.62 and torch.equal(y1, kept / 0.6)


@pytest.mark.parametrize("fn", ["logits", "on_softmax"])
def test_cross_entropy_matches_jax(fn):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(7, 11)).astype(np.float32) * 3
    if fn == "on_softmax":
        logits = np.asarray(jax.nn.softmax(logits, axis=-1))
    labels = rng.integers(0, 11, 7)
    f_j = cross_entropy_logits_j if fn == "logits" else cross_entropy_on_softmax_j
    f_t = cross_entropy_logits if fn == "logits" else cross_entropy_on_softmax
    want, grad = jax.value_and_grad(f_j)(jnp.asarray(logits), jnp.asarray(labels, jnp.int32))
    x = t(logits).requires_grad_()
    got = f_t(x, t(labels, np.int32))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("role", ["generator", "discriminator"])
@pytest.mark.parametrize("name", ["cgan", "acgan"])
def test_load_jax_params_pairs_the_embedding_tables(name, role):
    """A 2-D ``weight`` without a sibling bias is an Embedding's table, not
    transposed (``tpugan/io/torch_interop.py:77-78,132-134``); the modules
    then agree with JAX's in eval mode."""
    mod_j, mod_t = TRAINERS[name]
    kw = dict(batch_size=B, latent_dim=LATENT, img_size=SIZE, n_classes=10)
    cfg_j, cfg_t = mod_j.Config(**kw), mod_t.Config(**kw)
    mods = mod_j.build(cfg_j)
    state = mod_j.create_state(cfg_j, mods)
    params, stats = np_tree(state.params[role]), np_tree(state.model_state.get(role, {}))
    m = mod_t.build(cfg_t, CPU)[role]
    load_jax_params(m, params, stats or None)
    emb = [k for k, v in m.named_modules() if isinstance(v, Embedding)]
    if name == "acgan" and role == "discriminator":
        assert emb == []
    else:
        key = emb[0] + ".weight"
        table = next(v for path, v in _leaves(params) if path[-1] == "embedding")
        assert np.array_equal(m.state_dict()[key].numpy(), table)
    m.eval()
    rng = np.random.default_rng(2)
    lbl = rng.integers(0, 10, 4).astype(np.int32)
    if role == "generator":
        x = rng.normal(size=(4, LATENT)).astype(np.float32)
        want, _ = _apply(mods[role], params, stats, x, lbl)
        with torch.no_grad():
            got = m(t(x), t(lbl, np.int64))
        np.testing.assert_allclose(got.numpy(), nchw(want), atol=1e-5)
    else:
        x = rng.uniform(-1, 1, (4, SIZE, SIZE, 1)).astype(np.float32)
        args = (lbl,) if name == "cgan" else ()
        want, _ = _apply(mods[role], params, stats, x, *args)
        with torch.no_grad():
            got = m(t(nchw(x)), *(t(a, np.int64) for a in args))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _apply(module, params, stats, *args):
    from tpugan.models._common import apply_mod

    return apply_mod(module, params, stats, *(jnp.asarray(a) for a in args), train=False)


def test_state_dict_keys_are_the_reference_layout():
    """cgan/cgan.py:43-91, acgan/acgan.py:47-100, sgan/sgan.py:76-99 (the
    generator as the JAX package has it, DCGAN's) and
    infogan/infogan.py:61-121, registered in the reference's order."""
    wb = lambda p: [f"{p}.weight", f"{p}.bias"]
    bn = lambda p: wb(p) + [f"{p}.running_mean", f"{p}.running_var", f"{p}.num_batches_tracked"]
    dcgan_g = (wb("l1.0") + bn("conv_blocks.0") + wb("conv_blocks.2") + bn("conv_blocks.3")
               + wb("conv_blocks.6") + bn("conv_blocks.7") + wb("conv_blocks.9"))
    trunk = (wb("conv_blocks.0") + wb("conv_blocks.3") + bn("conv_blocks.6") + wb("conv_blocks.7")
             + bn("conv_blocks.10") + wb("conv_blocks.11") + bn("conv_blocks.14"))
    want = {
        "cgan": (["label_emb.weight"] + wb("model.0") + wb("model.2") + bn("model.3")
                 + wb("model.5") + bn("model.6") + wb("model.8") + bn("model.9") + wb("model.11"),
                 ["label_embedding.weight"] + wb("model.0") + wb("model.2") + wb("model.5")
                 + wb("model.8")),
        "acgan": (["label_emb.weight"] + dcgan_g, trunk + wb("adv_layer.0") + wb("aux_layer.0")),
        "sgan": (dcgan_g, trunk + wb("adv_layer.0") + wb("aux_layer.0")),
        "infogan": (dcgan_g, trunk + wb("adv_layer.0") + wb("aux_layer.0")
                    + wb("latent_layer.0")),
    }
    for name, (g, d) in want.items():
        mod = TRAINERS[name][1]
        modules = mod.build(mod.Config(), CPU)
        assert list(modules["generator"].state_dict()) == g, name
        assert list(modules["discriminator"].state_dict()) == d, name
    D = ac_t.build(ac_t.Config(), CPU)["discriminator"]
    assert isinstance(D.adv_layer[-1], torch.nn.Sigmoid)
    assert isinstance(D.aux_layer[-1], torch.nn.Softmax)
    assert sg_t.build(sg_t.Config(), CPU)["discriminator"].aux_layer[0].out_features == 11
    D = ig_t.build(ig_t.Config(), CPU)["discriminator"]
    assert len(D.adv_layer) == len(D.latent_layer) == 1
    assert ig_t.build(ig_t.Config(), CPU)["generator"].l1[0].in_features == 62 + 10 + 2


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_config_flags_match_jax(name):
    mod_j, mod_t = TRAINERS[name]
    got = {f.name: (f.default, f.type) for f in dataclasses.fields(mod_t.Config)}
    want = {f.name: (f.default, f.type) for f in dataclasses.fields(mod_j.Config)}
    assert got == want


MAIN_ARGV = ["--synthetic_data", "--n_epochs", "1", "--max_batches", "5", "--batch_size", "8",
             "--latent_dim", str(LATENT), "--img_size", str(SIZE), "--sample_interval", "3",
             "--log_interval", "2"]


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_a_five_batch_main_writes_the_rows_and_samples_of_jax(tmp_path, name, capsys):
    """The same metric rows' steps and keys, logged batches and PNG names as
    the JAX trainer's main (infogan: its three folders); the port's losses
    finite, sgan's log line with the accuracy; cgan, acgan and infogan
    grids of 10 x 10, sgan's 5 a row."""
    mod_j, mod_t = TRAINERS[name]
    got = {}
    for side, main in (("jax", mod_j.main), ("port", lambda a: mod_t.main(a, CPU))):
        _, rows, pngs = run_main(main, MAIN_ARGV, tmp_path / side)
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch")]
        got[side] = ([(r["step"], sorted(r)) for r in rows],
                     [ln.split("] [D loss")[0] for ln in lines], sorted(pngs))
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
            grid = ((5 * (SIZE + 2) + 2, 2 * (SIZE + 2) + 2) if name == "sgan"
                    else (10 * (SIZE + 2) + 2,) * 2)
            assert all(png_size(data) == grid for data in pngs.values())
            if name in ("acgan", "sgan"):
                assert all(", acc: " in ln for ln in lines)
            if name == "infogan":
                assert all("[info loss: " in ln for ln in lines)
    assert got["port"] == got["jax"]
    dirs = ig_t.SAMPLE_DIRS if name == "infogan" else ("",)
    assert got["port"][2] == sorted(os.path.join(d, f) for d in dirs for f in ("0.png", "3.png"))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sampling_leaves_the_training_draws_alone(tmp_path, name):
    """A main that samples every batch and one that never samples train the
    same: the same rows and the same final state, generator included; and
    a sampler call leaves ``state.draws`` and G's running statistics as
    they were, and repeats itself at the same batches_done."""
    mod_t = TRAINERS[name][1]
    runs = []
    for interval in ("1", "0"):
        a = list(MAIN_ARGV)
        a[a.index("--sample_interval") + 1] = interval
        runs.append(run_main(lambda v: mod_t.main(v, CPU), a, tmp_path / interval))
    (s1, rows1, pngs1), (s0, rows0, pngs0) = runs
    assert rows1 == rows0 and pngs1 and not pngs0
    assert torch.equal(s1.draws.get_state(), s0.draws.get_state())
    for role, m in s1.modules.items():
        other = s0.modules[role].state_dict()
        assert all(torch.equal(v, other[k]) for k, v in m.state_dict().items()), role
    if name == "sgan":
        return
    cfg = mod_t.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE,
                       output_dir=str(tmp_path / "direct"))
    draws = s1.draws.get_state()
    stats = {k: v.clone() for k, v in s1.modules["generator"].state_dict().items()}
    sample = mod_t.make_sampler(cfg)
    pngs = []
    for _ in range(2):
        sample(s1, {}, 7)
        pngs.append({os.path.join(r, f): open(os.path.join(r, f), "rb").read()
                     for r, _, fs in os.walk(tmp_path / "direct") for f in fs})
    assert pngs[0] == pngs[1] and pngs[0]
    assert torch.equal(s1.draws.get_state(), draws)
    after = s1.modules["generator"].state_dict()
    assert all(torch.equal(v, after[k]) for k, v in stats.items())


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_runs_raise_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TRAINERS[name][1].main(["--synthetic_data", "--output_dir", str(tmp_path)])


def test_cli_lists_thirteen_trainers(capsys):
    """The registry as it stands: the thirteen trainers above, the im2im
    ones (pix2pix, discogan, dualgan, context_encoder, ccgan, stargan, unit),
    the two-domain pair (pixelda, cogan) and the rest of templates A/B
    (bgan, softmax_gan, relativistic_gan, ebgan, began, aae, cluster_gan)."""
    from tpugan_torch.__main__ import main

    assert main(["list"]) == 0
    names = [ln.strip() for ln in capsys.readouterr().out.splitlines()[2:]]
    assert names == ["aae", "acgan", "began", "bgan", "ccgan", "cgan", "cluster_gan", "cogan",
                     "context_encoder", "cyclegan", "dcgan", "discogan", "dragan", "dualgan",
                     "ebgan", "gan", "infogan", "lsgan", "munit", "pix2pix", "pixelda",
                     "relativistic_gan", "sgan", "softmax_gan", "stargan", "unit", "wgan",
                     "wgan_div", "wgan_gp"]
