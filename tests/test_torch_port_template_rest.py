"""The rest of templates A and B in the port, bgan, softmax_gan,
relativistic_gan, ebgan, began and aae, and the losses, layers and blocks
they bring (``bce_with_logits``, ``boundary_seeking``, ``pullaway``,
``Linear(init_mode="normal02zero")``, ``DCGANGenerator``/``DCGANTrunk`` in
torch's init), against the JAX package on the CPU at img_size 16, batch 8,
latent 16.

One step of each trainer goes against one ``jax.jit`` of the JAX step, with
the harness of ``tests/test_torch_port_critic_rest.py``: the same weights
through ``load_jax_params``; the JAX step's z, aae's eps and real codes and
relativistic_gan's four sets of Dropout2d keep masks read off its own key
splits and passed in; the gradients each optimizer applies recorded on both
sides (aae's "g" over the encoder and the decoder). relativistic_gan runs in
its three G-loss branches; began's k is also followed over two steps.
Tolerances are that file's: losses (and began's M and k) 1e-5 relative,
images 1e-5 absolute, gradients 1e-3 relative plus 1e-4 of the module's
largest, each update Adam's first step of the port's own gradient (1e-6
relative, 1e-7 absolute) and within 1e-5 of JAX's where settled, running
statistics 1e-4 relative and 1e-6 absolute. began's k after two steps:
1e-8 absolute, LAMBDA_K (1e-3) times the losses' 1e-5 on losses of order
one. The losses alone: values 1e-5 relative, gradients 1e-5 relative plus
1e-6 of the largest; the layers' outputs 1e-6 absolute. Two departures from
one-to-one, each argued where it is made: ebgan's and began's gradients
are held to the JAX step run in float64 (``FLOAT64_HELD``), and
relativistic_gan's two shift-free biases are held to zero, not to JAX
(``SHIFT_FREE``).
"""

import dataclasses
import functools
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
    _recording,
    adam_first_step,
    check_gradients,
    check_losses_and_images,
    check_params,
    check_running_stats,
    make_ref,
    nchw,
    np_tree,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    png_size,
    port_modules,
    record_updates,
    run_main,
    t,
)

from tpugan.losses import bce_with_logits as bce_with_logits_j
from tpugan.losses import boundary_seeking as boundary_seeking_j
from tpugan.losses import pullaway as pullaway_j
from tpugan.models import aae as aae_j
from tpugan.models import began as began_j
from tpugan.models import bgan as bgan_j
from tpugan.models import ebgan as ebgan_j
from tpugan.models import relativistic_gan as rel_j
from tpugan.models import softmax_gan as sm_j
from tpugan.models._common import apply_mod
from tpugan.nn.blocks import DCGANGenerator as DCGANGenerator_j
from tpugan.nn.blocks import DCGANTrunk as DCGANTrunk_j
from tpugan.nn.layers import Linear as Linear_j
from tpugan.train.state import normalize_uint8 as normalize_uint8_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.losses import bce_with_logits, boundary_seeking, pullaway
from tpugan_torch.models import aae as aae_t
from tpugan_torch.models import began as began_t
from tpugan_torch.models import bgan as bgan_t
from tpugan_torch.models import ebgan as ebgan_t
from tpugan_torch.models import relativistic_gan as rel_t
from tpugan_torch.models import softmax_gan as sm_t
from tpugan_torch.nn.blocks import DCGANGenerator, DCGANTrunk
from tpugan_torch.nn.layers import Linear
from tpugan_torch.train.state import normalize_uint8

TRAINERS = {"aae": (aae_j, aae_t), "began": (began_j, began_t), "bgan": (bgan_j, bgan_t),
            "ebgan": (ebgan_j, ebgan_t), "relativistic_gan": (rel_j, rel_t),
            "softmax_gan": (sm_j, sm_t)}


def _z(key, cfg, b):
    return t(jax.random.normal(key, (b, cfg.latent_dim)))


def _draws_z(rng, cfg, shape):
    """bgan, softmax_gan, ebgan, began: ``rng, k_z = split(state.rng)``."""
    _, k_z = jax.random.split(rng)
    return {"z": _z(k_z, cfg, shape[0])}, []


def _draws_relativistic(rng, cfg, shape):
    """``tpugan/models/relativistic_gan.py:101-102``: z, then the dropout keys
    of D's four forwards."""
    _, k_z, k1, k2, k3, k4 = jax.random.split(rng, 6)
    return {"z": _z(k_z, cfg, shape[0])}, [k1, k2, k3, k4]


def _draws_aae(rng, cfg, shape):
    """``tpugan/models/aae.py:146-149,176``: eps, then D's real codes."""
    _, k_eps, k_z = jax.random.split(rng, 3)
    return {"eps": _z(k_eps, cfg, shape[0]), "z": _z(k_z, cfg, shape[0])}, []


REL = {"generator": 1, "discriminator": 4}
AE = {"generator": 1, "discriminator": 3}
SPECS = {
    "bgan": Spec(bgan_j, bgan_t, _draws_z, {"generator": 1}),
    "softmax_gan": Spec(sm_j, sm_t, _draws_z, {"generator": 1}),
    "relativistic_gan": Spec(rel_j, rel_t, _draws_relativistic, REL),
    "relativistic_gan_avg": Spec(rel_j, rel_t, _draws_relativistic, REL,
                                 cfg={"rel_avg_gan": True}),
    "relativistic_gan_quirks": Spec(rel_j, rel_t, _draws_relativistic, REL,
                                    cfg={"reference_quirks": True}),
    "ebgan": Spec(ebgan_j, ebgan_t, _draws_z, AE),
    "began": Spec(began_j, began_t, _draws_z, AE),
    "aae": Spec(aae_j, aae_t, _draws_aae, {"encoder": 1, "decoder": 1}),
}
LOSSES = {name: ("d_loss", "g_loss") for name in SPECS}
LOSSES["began"] = ("d_loss", "g_loss", "M", "k")


# ebgan's and began's discriminators normalize 64 * (s/2)^2 features over
# the batch (BatchNorm1d after Linear(32 -> 4096)) whose batch mean is up to
# 1,411 times their spread at the test's seed: the 32 features before the
# Linear come out of BatchNorm1d(eps=0.8) near 0, so the Linear's bias
# dominates, and a float32 rounding of the Linear's output becomes up to
# 1e-3 of the normalized one. There flax's one-pass variance, E[x^2] -
# E[x]^2, loses most of its digits: JAX's BatchNorm output lay 2.6e-4 from a
# float64 evaluation, the port's (two-pass) 1.5e-5, and JAX's float32
# gradients lie beyond the harness's floor (1e-4 of the largest) from its
# own float64 step's. So for these two the referee is the JAX step run in
# float64 (``jax_step_f64``): the port's float32 gradients are held to it
# at the harness's tolerance, and the port's step run in float64
# (``port_step_f64``) at the losses' tolerance.
FLOAT64_HELD = {"ebgan", "began"}

# A shift common to D's predictions on the real and the fake batch leaves
# every relativistic loss as it is, so the gradients of the discriminator's
# output bias and of its last BatchNorm's bias are exactly zero: each side's
# is the rounding of sums that cancel (up to 4e-9 against D's largest
# gradient of 2.7e-5 under --rel_avg_gan). They are held to 1e-3 of D's
# largest gradient, each update to Adam's first step of the port's own
# gradient, and left out of the comparison with JAX.
SHIFT_FREE = {("discriminator", "adv_layer.0.bias"), ("discriminator", "model.14.bias")}


@functools.lru_cache(maxsize=None)
def ref_of(name):
    r = make_ref(SPECS[name])
    r["name"] = name
    if name.startswith("relativistic_gan"):
        (call,) = r["rec"]["discriminator"]
        largest = max(float(g.abs().max()) for _, g, _ in call.values())
        for key in SHIFT_FREE:
            before, g, after = call.pop(key)
            assert float(g.abs().max()) <= 1e-3 * largest, key
            assert float(r["grads_j"]["discriminator"]["discriminator"][key[1]].abs().max()) \
                <= 1e-3 * largest, key
            torch.testing.assert_close(after, adam_first_step(before, g, r["cfg_t"].lr),
                                       rtol=1e-6, atol=1e-7)
        r["exempt"] = SHIFT_FREE
    return r


@pytest.fixture(scope="module", params=sorted(SPECS))
def ref(request):
    return ref_of(request.param)


def test_step_losses_and_images_match_jax(ref):
    """Losses (began's M and k too) and G's images; aae returns none."""
    check_losses_and_images(ref, LOSSES[ref["name"]])
    assert sorted(ref["out_t"]) == sorted(ref["out"])


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def jax_step_f64(name):
    """The gradients each JAX optimizer takes in one step of ``make_ref``'s,
    from the same weights, batch and draws, run in float64 under
    ``jax.enable_x64``: the state cast up, the normalized batch and z drawn
    in float32 as the float32 step draws them and then cast. By
    (optimizer, role, key), in the port's layout; ``load_jax_params``
    rounds each to float32 (6e-8 relative)."""
    r = ref_of(name)
    spec, cfg_t = SPECS[name], r["cfg_t"]
    cfg = spec.mod_j.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE, synthetic_data=True)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (B, SIZE, SIZE, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, B).astype(np.int32)
    normal = jax.random.normal
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spec.mod_j, "adam_torch", _recording(spec.mod_j.adam_torch))
        mods = spec.mod_j.build(cfg)
        state0 = spec.mod_j.create_state(cfg, mods)
        step = spec.mod_j.make_step(cfg, mods)
        mp.setattr(spec.mod_j, "normalize_uint8",
                   lambda x: normalize_uint8_j(x).astype(jnp.float64))
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                   normal(key, shape, jnp.float32).astype(jnp.float64))
        with jax.enable_x64(True):
            state1, out = jax.jit(step)(_f64(state0), imgs, labels)
            assert out["g_loss"].dtype == jnp.float64
            opt_state = np_tree(state1.opt_state)
    params0 = np_tree(state0.params)
    for role, tree in r["params0"].items():
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params0[role])):
            assert np.array_equal(a, b), role
    grads = {}
    for opt, st in opt_state.items():
        m = spec.mod_t.build(cfg_t, CPU)[opt].double()
        load_jax_params(m, st["g"], r["stats0"].get(opt) or None)
        grads.update({(opt, opt, k): v.detach() for k, v in m.state_dict().items()})
    return grads


def port_step_f64(name):
    """The gradients each optimizer of the port's step takes, with the
    step's weights, batch and draws, run in float64 (modules, draws and the
    normalized batch; the losses that cast to float32 round their inputs
    once, 6e-8 relative), by (optimizer, role, key)."""
    r = ref_of(name)
    spec, cfg = SPECS[name], r["cfg_t"]
    modules = {k: m.double() for k, m in
               port_modules(spec, cfg, r["params0"], r["stats0"]).items()}
    state = spec.mod_t.create_state(cfg, modules, CPU)
    rec = record_updates(state)
    cfg_j = spec.mod_j.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE)
    kw, _ = spec.draws(spec.mod_j.create_state(cfg_j, spec.mod_j.build(cfg_j)).rng, cfg_j,
                       (B, SIZE, SIZE, 1))
    imgs = np.random.default_rng(5).integers(0, 256, (B, SIZE, SIZE, 1), dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spec.mod_t, "normalize_uint8", lambda x: normalize_uint8(x).double())
        spec.mod_t.make_step(cfg, state)(state, t(imgs), None,
                                         **{k: v.double() for k, v in kw.items()})
    return {(opt, role, k): g for opt, (call,) in rec.items() for (role, k), (_, g, _) in
            call.items()}


def check_gradients_f64(ref):
    """``check_gradients`` against JAX's step in float64: the port's float32
    gradients within the harness's tolerance of it (1e-3 relative plus 1e-4
    of the module's largest), and the port's step in float64 within the
    losses' (1e-5 relative plus 1e-6 of the largest)."""
    want = jax_step_f64(ref["name"])
    port64 = port_step_f64(ref["name"])
    for opt, (call,) in ref["rec"].items():
        largest = max(float(w.abs().max()) for (o, _, k), w in want.items()
                      if o == opt and "running" not in k and w.is_floating_point())
        for (role, k), (_, g, _) in call.items():
            w = want[opt, role, k]
            np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=1e-3,
                                       atol=1e-4 * largest, err_msg=f"{opt} {role} {k}")
            np.testing.assert_allclose(port64[opt, role, k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6 * largest, err_msg=f"{opt} {role} {k} f64")


def test_step_gradients_match_jax(ref):
    """Every optimizer's gradients: softmax_gan's G on grad(d_loss + g_loss)
    from the one forward; aae's "g" over the encoder and the decoder, D's
    over the latent discriminator; ebgan's and began's held to JAX's step
    in float64 (``FLOAT64_HELD``)."""
    if ref["name"] in FLOAT64_HELD:
        check_gradients_f64(ref)
    else:
        check_gradients(ref)
    if ref["name"] == "aae":
        assert {r for r, _ in ref["rec"]["g"][0]} == {"encoder", "decoder"}


def test_step_params_match_jax(ref):
    check_params(ref)


def test_step_running_stats_match_jax(ref):
    """G's after its forward; relativistic_gan's D after four (the G phase's
    on the real batch among them), ebgan's and began's after three; aae's
    encoder and decoder after one each."""
    check_running_stats(ref)


def test_relativistic_g_loss_branches_differ_in_g():
    """The three references start from the same weights and draws. The
    quirk touches G's loss alone: its D step is the default's bit for bit.
    G takes a different gradient in each of the three, and RaGAN's D loss
    differs from RSGAN's."""
    a, avg, quirk = (ref_of(n) for n in ("relativistic_gan", "relativistic_gan_avg",
                                         "relativistic_gan_quirks"))
    g = lambda r, role: r["rec"][role][0]
    for x, y in ((a, avg), (a, quirk), (avg, quirk)):
        assert any(not torch.equal(g(x, "generator")[k][1], g(y, "generator")[k][1])
                   for k in g(x, "generator"))
    for k, (_, grad, _) in g(a, "discriminator").items():
        assert torch.equal(grad, g(quirk, "discriminator")[k][1]), k
    assert float(a["out_t"]["d_loss"]) == float(quirk["out_t"]["d_loss"])
    assert float(a["out_t"]["d_loss"]) != float(avg["out_t"]["d_loss"])


def test_began_k_over_two_steps_matches_jax():
    """Two JAX steps and two of the port from the same weights and draws:
    k and M after each, and k carried in ``state.aux`` in place (the same
    tensor object throughout)."""
    kw = dict(batch_size=B, latent_dim=LATENT, img_size=SIZE, synthetic_data=True)
    cfg_j, cfg_t = began_j.Config(**kw), began_t.Config(**kw)
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (B, SIZE, SIZE, 1), dtype=np.uint8) for _ in range(2)]
    labels = np.zeros(B, np.int32)
    mods = began_j.build(cfg_j)
    state_j = began_j.create_state(cfg_j, mods)
    step_j = jax.jit(began_j.make_step(cfg_j, mods))
    params0, stats0 = np_tree(state_j.params), np_tree(state_j.model_state)
    modules = began_t.build(cfg_t, CPU)
    for role, m in modules.items():
        load_jax_params(m, params0[role], stats0[role])
    state = began_t.create_state(cfg_t, modules, CPU)
    k = state.aux["k"]
    step = began_t.make_step(cfg_t, state)
    for x in imgs:
        _, k_z = jax.random.split(state_j.rng)
        state_j, out_j = step_j(state_j, x, labels)
        state, out = step(state, t(x), None, z=_z(k_z, cfg_j, B))
        np.testing.assert_allclose(float(out["M"]), float(out_j["M"]), rtol=1e-5)
        np.testing.assert_allclose(float(out["k"]), float(out_j["k"]), rtol=0, atol=1e-8)
        assert float(out["k"]) > 0
    assert state.aux["k"] is k and float(k) == float(out["k"])
    np.testing.assert_allclose(float(k), float(state_j.aux["k"]), rtol=0, atol=1e-8)


# --- Losses, layers, blocks -----------------------------------------------------


@pytest.mark.parametrize("name", ["bce_with_logits", "boundary_seeking", "pullaway"])
def test_losses_match_jax(name):
    """Values and input gradients; pullaway's unsquared cosine form and its
    (sum - N) / (N(N-1)) normalisation."""
    rng = np.random.default_rng(2)
    if name == "bce_with_logits":
        x = (rng.normal(size=(9, 1)) * 4).astype(np.float32)
        fns = [(lambda a, tg=tg: bce_with_logits_j(a, tg), lambda a, tg=tg: bce_with_logits(a, tg))
               for tg in (0.0, 1.0)]
    elif name == "boundary_seeking":
        x = rng.uniform(0.02, 0.98, (9, 1)).astype(np.float32)
        fns = [(boundary_seeking_j, boundary_seeking)]
    else:
        x = rng.normal(size=(7, 32)).astype(np.float32)
        fns = [(pullaway_j, pullaway)]
        e = x / np.linalg.norm(x, axis=1, keepdims=True)
        want = ((e @ e.T).sum() - 7) / (7 * 6)
        np.testing.assert_allclose(float(pullaway(t(x))), want, rtol=1e-5)
    for f_j, f_t in fns:
        want, grad = jax.value_and_grad(f_j)(jnp.asarray(x))
        xt = t(x).requires_grad_()
        got = f_t(xt)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        grad = np.asarray(grad)
        np.testing.assert_allclose(xt.grad.numpy(), grad, rtol=1e-5,
                                   atol=1e-6 * np.abs(grad).max())


def test_linear_normal02zero_is_seeded_normal_with_zero_bias_and_matches_flax():
    w = Linear(512, 256, init_mode="normal02zero",
               generator=torch.Generator().manual_seed(0))
    assert not w.bias.detach().any()
    assert abs(float(w.weight.detach().std()) - 0.02) < 5e-4
    lin_j = Linear_j(6, init_mode="normal02zero")
    x = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    params = lin_j.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert not np.asarray(params["Dense_0"]["bias"]).any()
    lin = Linear(5, 6, init_mode="normal02zero")
    load_jax_params(lin, np_tree(params))
    with torch.no_grad():
        got = lin(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(lin_j.apply({"params": params}, x)),
                               atol=1e-6)


def test_dcgan_blocks_in_torch_init_match_flax():
    """``DCGANGenerator``/``DCGANTrunk`` with ``init_mode="torch"``: the convs
    kaiming-uniform within torch's bound, every BatchNorm at scale 1 and
    bias 0, as the flax modules' init; outputs in training against flax's
    from the same weights. The default stays ``normal02``."""
    gen = lambda: torch.Generator().manual_seed(0)
    g = DCGANGenerator(SIZE, 1, LATENT, init_mode="torch", generator=gen())
    d = DCGANTrunk(1, init_mode="torch", generator=gen())
    for m in (g, d):
        for layer in m.modules():
            if isinstance(layer, torch.nn.modules.batchnorm._BatchNorm):
                assert torch.equal(layer.weight, torch.ones_like(layer.weight))
                assert not layer.bias.detach().any()
            if isinstance(layer, torch.nn.Conv2d):
                fan_in = layer.in_channels * 9
                assert float(layer.weight.detach().abs().max()) <= 1 / np.sqrt(fan_in)
    default = DCGANTrunk(1, generator=gen())
    assert float(default[0].weight.detach().std()) == pytest.approx(0.02, rel=0.3)
    bn = [m for m in default.modules() if isinstance(m, torch.nn.BatchNorm2d)][0]
    assert not torch.equal(bn.weight, torch.ones_like(bn.weight))

    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, LATENT)).astype(np.float32)
    x = rng.uniform(-1, 1, (4, SIZE, SIZE, 1)).astype(np.float32)
    g_j = DCGANGenerator_j(img_size=SIZE, channels=1, init_mode="torch")
    v = g_j.init(jax.random.PRNGKey(1), jnp.asarray(z), train=True)
    assert all(np.all(np.asarray(bn["scale"]) == 1) for k, bn in v["params"].items()
               if k.startswith("BatchNorm"))
    want, _ = apply_mod(g_j, v["params"], v["batch_stats"], jnp.asarray(z), train=True)
    load_jax_params(g, np_tree(v["params"]), np_tree(v["batch_stats"]))
    np.testing.assert_allclose(g(t(z)).detach().numpy(), nchw(want), atol=1e-6)
    d_j = DCGANTrunk_j(init_mode="torch")
    v = d_j.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    want, _ = apply_mod(d_j, v["params"], v["batch_stats"], jnp.asarray(x), train=False)
    load_jax_params(d, np_tree(v["params"]), np_tree(v["batch_stats"]))
    d.eval()
    with torch.no_grad():
        np.testing.assert_allclose(d(t(nchw(x))).numpy(), np.asarray(want), atol=1e-6)


# --- Modules, flags, mains -------------------------------------------------------------


def test_state_dict_keys_are_the_reference_layout():
    """bgan/bgan.py:40-82 (gan's), softmax_gan without the Sigmoid,
    relativistic_gan (DCGAN's, no Sigmoid), ebgan/ebgan.py:47-101,
    began/began.py:47-99 and aae/aae.py:46-105."""
    wb = lambda p: [f"{p}.weight", f"{p}.bias"]
    bn = lambda p: wb(p) + [f"{p}.running_mean", f"{p}.running_var", f"{p}.num_batches_tracked"]
    mlp_g = (wb("model.0") + wb("model.2") + bn("model.3") + wb("model.5") + bn("model.6")
             + wb("model.8") + bn("model.9") + wb("model.11"))
    mlp_d = wb("model.0") + wb("model.2") + wb("model.4")
    conv_g = (wb("l1.0") + wb("conv_blocks.1") + bn("conv_blocks.2") + wb("conv_blocks.5")
              + bn("conv_blocks.6") + wb("conv_blocks.8"))
    dcgan_g = (wb("l1.0") + bn("conv_blocks.0") + wb("conv_blocks.2") + bn("conv_blocks.3")
               + wb("conv_blocks.6") + bn("conv_blocks.7") + wb("conv_blocks.9"))
    trunk = (wb("model.0") + wb("model.3") + bn("model.6") + wb("model.7") + bn("model.10")
             + wb("model.11") + bn("model.14"))
    want = {
        "bgan": {"generator": mlp_g, "discriminator": mlp_d},
        "softmax_gan": {"generator": mlp_g, "discriminator": mlp_d},
        "relativistic_gan": {"generator": dcgan_g, "discriminator": trunk + wb("adv_layer.0")},
        "ebgan": {"generator": conv_g,
                  "discriminator": wb("down.0") + wb("embedding") + bn("fc.0") + wb("fc.2")
                  + bn("fc.3") + wb("up.1")},
        "began": {"generator": dcgan_g,
                  "discriminator": wb("down.0") + wb("fc.0") + bn("fc.1") + wb("fc.3")
                  + bn("fc.4") + wb("up.1")},
        "aae": {"encoder": wb("model.0") + wb("model.2") + bn("model.3") + wb("mu")
                + wb("logvar"),
                "decoder": wb("model.0") + wb("model.2") + bn("model.3") + wb("model.5"),
                "discriminator": mlp_d},
    }
    for name, roles in want.items():
        mod = TRAINERS[name][1]
        modules = mod.build(mod.Config(), CPU)
        assert {r: list(m.state_dict()) for r, m in modules.items()} == roles, name
    assert isinstance(bgan_t.build(bgan_t.Config(), CPU)["discriminator"].model[-1],
                      torch.nn.Sigmoid)
    assert not isinstance(sm_t.build(sm_t.Config(), CPU)["discriminator"].model[-1],
                          torch.nn.Sigmoid)
    d = ebgan_t.build(ebgan_t.Config(), CPU)["discriminator"]
    assert (d.fc[0].eps, d.fc[3].eps) == (0.8, 1e-5)
    assert torch.equal(d.fc[0].weight, torch.ones(32))  # torch init, not normal02
    assert aae_t.build(aae_t.Config(), CPU)["discriminator"].model[0].in_features == 10


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
    the JAX trainer's main; the port's losses finite, began's line with M
    and k; grids 5 a row, aae's 10 x 10."""
    mod_j, mod_t = TRAINERS[name]
    got = {}
    for side, main in (("jax", mod_j.main), ("port", lambda a: mod_t.main(a, CPU))):
        _, rows, pngs = run_main(main, MAIN_ARGV, tmp_path / side)
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch")]
        got[side] = ([(r["step"], sorted(r)) for r in rows],
                     [ln.split("] [D loss")[0] for ln in lines], sorted(pngs))
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
            grid = ((10 * (SIZE + 2) + 2,) * 2 if name == "aae"
                    else (5 * (SIZE + 2) + 2, 2 * (SIZE + 2) + 2))
            assert all(png_size(data) == grid for data in pngs.values())
            if name == "began":
                assert all(" -- M: " in ln and ", k: " in ln for ln in lines)
    assert got["port"] == got["jax"]
    assert got["port"][2] == ["0.png", "3.png"]


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_fused_main_writes_the_unfused_rows_and_samples(tmp_path, name, capsys):
    """7 batches an epoch, 2 epochs, K = 3: two dispatches and a tail of one
    each epoch. The rows and log lines are the unfused loop's bit for bit;
    a sample due inside a dispatch is its last step's images (aae's, G's
    own codes after the dispatch) and so equals the unfused run's where the
    step is a dispatch's last or in a tail."""
    mod = TRAINERS[name][1]
    argv = ["--synthetic_data", "--n_epochs", "2", "--max_batches", "7", "--batch_size", "8",
            "--latent_dim", str(LATENT), "--img_size", str(SIZE), "--sample_interval", "1",
            "--log_interval", "3"]
    runs, logs = {}, {}
    for k in (1, 3):
        runs[k] = run_main(lambda a: mod.main(a, CPU), argv + ["--steps_per_dispatch", str(k)],
                           tmp_path / str(k))
        logs[k] = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch")]
    (s1, rows1, png1), (s3, rows3, png3) = runs[1], runs[3]
    assert rows3 == rows1 and [r["step"] for r in rows1] == list(range(14))
    assert logs[3] == logs[1] and len(logs[1]) == 6
    assert sorted(png3) == sorted(png1) == sorted(f"{i}.png" for i in range(14))
    for i in (2, 5, 6, 9, 12, 13):  # a dispatch's last step, or a tail
        assert png3[f"{i}.png"] == png1[f"{i}.png"], i
    for role, m in s1.modules.items():
        other = s3.modules[role].state_dict()
        assert all(torch.equal(v, other[k]) for k, v in m.state_dict().items()), role
    assert {n: float(v) for n, v in s1.aux.items()} == {n: float(v) for n, v in s3.aux.items()}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sampling_leaves_the_training_draws_alone(tmp_path, name):
    """A main that samples every batch and one that never samples train the
    same: the same rows and final state, generator included; aae's sampler
    leaves ``state.draws`` and the decoder's running statistics as they
    were and repeats itself at the same batches_done."""
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
    if name != "aae":
        return
    cfg = aae_t.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE,
                       output_dir=str(tmp_path / "direct"))
    draws = s1.draws.get_state()
    stats = {k: v.clone() for k, v in s1.modules["decoder"].state_dict().items()}
    sample = aae_t.make_sampler(cfg)
    pngs = []
    for _ in range(2):
        sample(s1, {}, 7)
        pngs.append({f: open(os.path.join(tmp_path / "direct" / "images", f), "rb").read()
                     for f in os.listdir(tmp_path / "direct" / "images")})
    assert pngs[0] == pngs[1] and list(pngs[0]) == ["7.png"]
    assert png_size(pngs[0]["7.png"]) == (10 * (SIZE + 2) + 2,) * 2
    assert torch.equal(s1.draws.get_state(), draws)
    after = s1.modules["decoder"].state_dict()
    assert all(torch.equal(v, after[k]) for k, v in stats.items())


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_runs_raise_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TRAINERS[name][1].main(["--synthetic_data", "--output_dir", str(tmp_path)])
