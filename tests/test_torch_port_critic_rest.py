"""The rest of the port's critic family, gan, wgan_div and dragan, and the
DRAGAN and Wasserstein-divergence penalties, against the JAX package on the
CPU at img_size 16, batch 8, latent 16.

One step of each trainer (wgan_div: one d_step and the g_step after it)
goes against one ``jax.jit`` of the JAX step from the same weights: the JAX
package's initial parameters and BatchNorm statistics go into the port's
modules through ``load_jax_params``. The JAX step's draws are read off its
own key splits and passed in: z, dragan's element-wise alpha and noise, and
the Dropout2d keep masks, read off the JAX discriminator applied with each
forward's dropout key and ``capture_intermediates`` (a channel is kept where
its output is not all zero). The gradients each JAX optimizer applies are
recorded by wrapping ``adam_torch`` for the step (Adam's arithmetic is
unchanged; its state also keeps the last gradients); the port's by wrapping
each optimizer's ``step``. The harness here also serves
``tests/test_torch_port_conditional.py``.

Tolerances, float32 on both sides with sums in different orders, none looser
than ``tests/test_torch_port_dcgan.py``'s:
- losses: 1e-5 relative; generated images: 1e-5 absolute;
- gradients: 1e-3 relative, plus 1e-4 of the largest gradient of that
  module absolute (a bias that feeds a BatchNorm has a true gradient of 0);
- parameters: each update is Adam's first step of the port's own gradient
  (1e-6 relative, 1e-7 absolute), and the result is within 1e-5 of JAX's
  where every gradient it took is above that noise floor;
- running statistics after the step: 1e-4 relative and 1e-6 absolute;
- the penalties: the value 1e-5 relative, parameter gradients as above.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpugan.models import _template_b as tb_j
from tpugan.models import dcgan as dc_j
from tpugan.models import dragan as dr_j
from tpugan.models import gan as gan_j
from tpugan.models import wgan_div as wd_j
from tpugan.models._common import apply_mod
from tpugan.nn.blocks import MLPDiscriminator as MLPDiscriminator_j
from tpugan.nn.layers import Dropout as Dropout_j
from tpugan.nn.layers import Dropout2d as Dropout2d_j
from tpugan.ops.penalty import dragan_penalty as dragan_penalty_j
from tpugan.ops.penalty import wdiv_penalty as wdiv_penalty_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import dcgan as dc_t
from tpugan_torch.models import dragan as dr_t
from tpugan_torch.models import gan as gan_t
from tpugan_torch.models import wgan_div as wd_t
from tpugan_torch.nn.blocks import MLPDiscriminator
from tpugan_torch.nn.layers import batch_stats_frozen
from tpugan_torch.ops.penalty import dragan_penalty, wdiv_penalty

CPU = torch.device("cpu")
B, LATENT, SIZE = 8, 16, 16
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests on one intra-op thread, restored after. The tests
    run in several worker processes at once, and torch's default of a
    thread a core then oversubscribes the host: a small model's step slows
    about 30x. Other port test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


# --- The harness ---------------------------------------------------------------


def _intermediate_calls(tree):
    for k, v in tree.items():
        if k == "__call__":
            yield v[0]
        else:
            yield from _intermediate_calls(v)


def jax_masks(D, params, stats, key, shape, *args):
    """The dropout keep masks the JAX module ``D`` draws with ``key``, in
    call order: (B, C, 1, 1) for Dropout2d, the input's shape for Dropout.
    They depend on the key and the shapes only, so a random input of the
    step's shape reads them."""
    x = jnp.asarray(np.random.default_rng(9).normal(size=shape).astype(np.float32))
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    _, mut = D.apply(variables, x, *args, train=True, rngs={"dropout": key},
                     mutable=["batch_stats", "intermediates"],
                     capture_intermediates=lambda m, _: isinstance(m, (Dropout_j, Dropout2d_j)))
    masks = []
    for out in _intermediate_calls(mut["intermediates"]):
        out = np.asarray(out)
        if out.ndim == 4:
            masks.append(np.any(out != 0, axis=(1, 2)).astype(np.float32)[:, :, None, None])
        else:
            masks.append((out != 0).astype(np.float32))
    return masks


def _recording(adam):
    """``adam_torch`` whose state also holds the gradients of its last
    update, under ``"g"``; the update itself is Adam's."""

    def make(*args, **kw):
        tx = adam(*args, **kw)

        def init(params):
            return {"adam": tx.init(params), "g": jax.tree_util.tree_map(jnp.zeros_like, params)}

        def update(grads, state, params=None):
            updates, adam_state = tx.update(grads, state["adam"], params)
            return updates, {"adam": adam_state, "g": grads}

        return optax.GradientTransformation(init, update)

    return make


@dataclasses.dataclass
class Spec:
    """A trainer under test. ``draws(rng, cfg, shape)`` returns the port
    step's keyword draws (numpy, NCHW) and the dropout keys of D's forwards
    in order, both from the JAX step's key splits. ``forwards`` counts the
    BatchNorm updates a step by role."""

    mod_j: object
    mod_t: object
    draws: object
    forwards: dict
    cfg: dict = dataclasses.field(default_factory=dict)
    critic: bool = False
    d_args: tuple = ()


def run_jax(spec, cfg, imgs, labels):
    with pytest.MonkeyPatch.context() as mp:
        for m in {spec.mod_j, tb_j}:
            if hasattr(m, "adam_torch"):
                mp.setattr(m, "adam_torch", _recording(m.adam_torch))
        mods = spec.mod_j.build(cfg)
        state0 = spec.mod_j.create_state(cfg, mods)
        if spec.critic:
            d_step, g_step = spec.mod_j.make_steps(cfg, mods)
            s1, d_out = jax.jit(d_step)(state0, imgs, labels)
            state1, g_out = jax.jit(g_step)(s1, d_out["z"])
            out = {**d_out, **g_out}
        else:
            state1, out = jax.jit(spec.mod_j.make_step(cfg, mods))(state0, imgs, labels)
    return mods, state0, state1, out


def record_updates(state):
    """Wrap each optimizer's ``step``: for each call, every parameter's
    (value before, gradient or None, value after), by (role, key)."""
    names = {id(p): (role, k) for role, m in state.modules.items()
             for k, p in m.named_parameters()}
    rec = {}
    for name, opt in state.optimizers.items():
        params = [p for g in opt.param_groups for p in g["params"]]

        def step(*a, _name=name, _params=params, _orig=opt.step, **kw):
            before = [(p.detach().clone(), None if p.grad is None else p.grad.clone())
                      for p in _params]
            result = _orig(*a, **kw)
            rec.setdefault(_name, []).append(
                {names[id(p)]: (b, g, p.detach().clone()) for (b, g), p in zip(before, _params)})
            return result

        opt.step = step
    return rec


def port_modules(spec, cfg, params, stats):
    modules = spec.mod_t.build(cfg, CPU)
    for role, m in modules.items():
        load_jax_params(m, params[role], stats.get(role) or None)
    return modules


def as_port(spec, cfg, role, tree, stats):
    """A JAX tree of one role in the port's layout, by state_dict key."""
    m = spec.mod_t.build(cfg, CPU)[role]
    load_jax_params(m, tree, stats.get(role) or None)
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def make_ref(spec):
    """One JAX step and the same step of the port, from the same weights,
    batch and draws."""
    cfg_j = spec.mod_j.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE,
                              synthetic_data=True, **spec.cfg)
    cfg_t = spec.mod_t.Config(batch_size=B, latent_dim=LATENT, img_size=SIZE,
                              synthetic_data=True, **spec.cfg)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (B, SIZE, SIZE, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, B).astype(np.int32)
    mods, state0, state1, out = run_jax(spec, cfg_j, imgs, labels)
    params0, stats0 = np_tree(state0.params), np_tree(state0.model_state)
    kw, keys = spec.draws(state0.rng, cfg_j, imgs.shape)
    if keys:
        D = mods["discriminator"]
        kw["masks"] = [[t(m) for m in jax_masks(D, params0["discriminator"],
                                                 stats0.get("discriminator"), k, imgs.shape,
                                                 *spec.d_args)]
                       for k in keys]

    modules = port_modules(spec, cfg_t, params0, stats0)
    state = spec.mod_t.create_state(cfg_t, modules, CPU)
    rec = record_updates(state)
    if spec.critic:
        d_step, g_step = spec.mod_t.make_steps(cfg_t, state)
        state, d_out = d_step(state, t(imgs), None, **kw)
        state, g_out = g_step(state, d_out["z"])
        out_t = {**d_out, **g_out}
    else:
        state, out_t = spec.mod_t.make_step(cfg_t, state)(state, t(imgs), t(labels), **kw)
    grads_j = {}
    for name, st in np_tree(state1.opt_state).items():
        # An optimizer over several modules (infogan's "info", aae's "g")
        # records a tree by role.
        trees = st["g"] if set(st["g"]) <= set(mods) else {name: st["g"]}
        for role, tree in trees.items():
            grads_j.setdefault(name, {})[role] = as_port(spec, cfg_t, role, tree, stats0)
    return {
        "spec": spec, "cfg_t": cfg_t, "mods": mods, "state": state, "rec": rec,
        "params0": params0, "stats0": stats0, "out": {k: np.asarray(v) for k, v in out.items()},
        "params1": np_tree(state1.params), "stats1": np_tree(state1.model_state),
        "grads_j": grads_j, "out_t": out_t, "modules": modules,
    }


def check_losses_and_images(ref, keys):
    """The losses ``keys``, and the images where the JAX step returns them
    (aae's does not, nor then the port's)."""
    for k in keys:
        np.testing.assert_allclose(float(ref["out_t"][k]), float(ref["out"][k]), rtol=1e-5,
                                   err_msg=k)
    assert ("gen_imgs" in ref["out_t"]) == ("gen_imgs" in ref["out"])
    if "gen_imgs" in ref["out"]:
        np.testing.assert_allclose(ref["out_t"]["gen_imgs"].numpy(),
                                   nchw(ref["out"]["gen_imgs"]), atol=1e-5)


def check_gradients(ref):
    """Every optimizer's recorded gradients against the JAX optimizer's of
    the same name; a parameter the port leaves without a gradient has
    JAX's exactly zero."""
    for name, calls in ref["rec"].items():
        assert len(calls) == 1, name
        want = ref["grads_j"][name]
        floor = {role: 1e-4 * max(float(g.abs().max()) for k, g in w.items()
                                  if g.dtype.is_floating_point and "running" not in k)
                 for role, w in want.items()}
        for (role, k), (_, g, _) in calls[0].items():
            w = want[role][k]
            if g is None:
                assert not w.any(), (name, role, k)
                continue
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=floor[role],
                                       err_msg=f"{name} {role} {k}")


def adam_first_step(p0, g, lr, eps=1e-8, weight_decay=0.0):
    """torch.optim.Adam's first update from ``p0`` with gradient ``g``: the
    bias-corrected moments are g and g**2, so the step is lr * g / (|g| + eps),
    ``weight_decay * p0`` first added to g as torch's ``Adam(weight_decay=)``
    adds it."""
    g = g.double() + weight_decay * p0.double()
    return (p0.double() - lr * g / (g.abs() + eps)).float()


def check_params(ref):
    """Each update is Adam's first step of the port's own gradient (with the
    optimizer's ``ref["weight_decay"]``, if any), and each final parameter
    agrees with JAX's where every gradient it took is above the noise floor
    of its module. Every parameter of every module is some optimizer's,
    except those that ``ref["exempt"]`` names on purpose, by role or by
    (role, key)."""
    cfg = ref["cfg_t"]
    settled = {}
    for name, calls in ref["rec"].items():
        want = ref["grads_j"][name]
        noise = {role: 1e-4 * max(float(g.abs().max()) for k, g in w.items()
                                  if g.dtype.is_floating_point and "running" not in k)
                 for role, w in want.items()}
        for (role, k), (before, g, after) in calls[0].items():
            if g is None:
                assert torch.equal(after, before), (name, role, k)
                continue
            wd = ref.get("weight_decay", {}).get(name, 0.0)
            torch.testing.assert_close(after, adam_first_step(before, g, cfg.lr, weight_decay=wd),
                                       rtol=1e-6, atol=1e-7,
                                       msg=lambda m: f"{name} {role} {k}: {m}")
            mask = want[role][k].abs() > noise[role]
            settled[role, k] = settled.get((role, k), True) & mask
    spec, exempt = ref["spec"], ref.get("exempt", ())
    for role, m in ref["modules"].items():
        final = as_port(spec, cfg, role, ref["params1"][role], ref["stats1"])
        for k, p in m.named_parameters():
            if role in exempt or (role, k) in exempt:
                assert (role, k) not in settled, (role, k)
                continue
            mask = settled[role, k]
            if mask.any():
                diff = (p.detach() - final[k]).abs()[mask]
                assert float(diff.max()) <= PARAM_ATOL, (role, k, float(diff.max()))


def check_running_stats(ref):
    spec, cfg = ref["spec"], ref["cfg_t"]
    for role, n in spec.forwards.items():
        want = as_port(spec, cfg, role, ref["params1"][role], ref["stats1"])
        for k, v in ref["modules"][role].state_dict().items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == n, (role, k, int(v))
            elif "running" in k:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"{role} {k}")
    for role in set(ref["modules"]) - set(spec.forwards):
        assert not any("running" in k for k in ref["modules"][role].state_dict()), role


# --- The three trainers ----------------------------------------------------------


def _draws_gan(rng, cfg, shape):
    _, k_z = jax.random.split(rng)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim)))}, []


def _draws_wgan_div(rng, cfg, shape):
    _, k_z, _ = jax.random.split(rng, 3)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim)))}, []


def _draws_dragan(rng, cfg, shape):
    _, k_z, k1, k2, k3, k4, k_pen = jax.random.split(rng, 7)
    k_alpha, k_noise = jax.random.split(k_pen)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim))),
            "alpha": t(nchw(jax.random.uniform(k_alpha, shape, jnp.float32))),
            "noise": t(nchw(jax.random.uniform(k_noise, shape, jnp.float32)))}, [k1, k2, k3, k4]


SPECS = {
    "gan": Spec(gan_j, gan_t, _draws_gan, {"generator": 1}),
    "wgan_div": Spec(wd_j, wd_t, _draws_wgan_div, {"generator": 2}, critic=True),
    "dragan": Spec(dr_j, dr_t, _draws_dragan, {"generator": 1, "discriminator": 3}),
    "dragan_quirks": Spec(dr_j, dr_t, _draws_dragan, {"generator": 1, "discriminator": 3},
                          cfg={"reference_quirks": True}),
}
TRAINERS = {"gan": (gan_j, gan_t), "wgan_div": (wd_j, wd_t), "dragan": (dr_j, dr_t)}


@functools.lru_cache(maxsize=None)
def ref_of(name):
    return make_ref(SPECS[name])


@pytest.fixture(scope="module", params=sorted(SPECS))
def ref(request):
    return ref_of(request.param)


def test_step_losses_and_images_match_jax(ref):
    check_losses_and_images(ref, ("d_loss", "g_loss"))


def test_step_gradients_match_jax(ref):
    check_gradients(ref)


def test_step_params_match_jax(ref):
    check_params(ref)


def test_step_running_stats_match_jax(ref):
    """G's after its forwards (wgan_div: the d_step's and the g_step's);
    DRAGAN's D after three, the penalty's forward leaving them alone."""
    check_running_stats(ref)


def test_dragan_quirks_update_d_by_the_penalty_alone():
    """The two dragan references take the same G step and report the same
    d_loss, but D's gradients differ: the quirk drops the BCE part."""
    a, b = ref_of("dragan"), ref_of("dragan_quirks")
    assert float(a["out_t"]["d_loss"]) == float(b["out_t"]["d_loss"])
    ga = a["rec"]["discriminator"][0]
    gb = b["rec"]["discriminator"][0]
    assert any(not torch.equal(ga[k][1], gb[k][1]) for k in ga)
    for k, (_, g, _) in a["rec"]["generator"][0].items():
        assert torch.equal(g, b["rec"]["generator"][0][k][1]), k


def test_wgan_div_d_step_draws_z_only():
    cfg = wd_t.Config(batch_size=B, latent_dim=LATENT, synthetic_data=True)
    state = wd_t.create_state(cfg, wd_t.build(cfg, CPU), CPU)
    d_step, _ = wd_t.make_steps(cfg, state)
    want = torch.Generator().manual_seed(cfg.seed)
    z = torch.randn(B, LATENT, generator=want)
    state, out = d_step(state, torch.zeros(B, 28, 28, 1, dtype=torch.uint8))
    assert torch.equal(out["z"], z)
    assert torch.equal(state.draws.get_state(), want.get_state())


# --- The penalties ------------------------------------------------------------------


def test_dragan_penalty_matches_jax_on_a_dcgan_critic():
    """The penalty and its parameter gradients on DCGAN's discriminator in
    training (BatchNorm on batch statistics, Dropout2d with the JAX masks);
    alpha and noise from the JAX penalty's own key split. The running
    statistics stay as they were."""
    cfg_j = dc_j.Config(img_size=SIZE)
    cfg_t = dc_t.Config(img_size=SIZE)
    D_j = dc_j.build(cfg_j)["discriminator"]
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, (B, SIZE, SIZE, 1)).astype(np.float32)
    variables = D_j.init(jax.random.PRNGKey(1), jnp.asarray(real), train=True)
    params, stats = variables["params"], variables["batch_stats"]
    k_drop, k_pen = jax.random.PRNGKey(2), jax.random.PRNGKey(4)

    def penalty(p):
        d_fn = lambda x: apply_mod(D_j, p, stats, x, train=True, dropout_rng=k_drop)[0]
        return dragan_penalty_j(d_fn, jnp.asarray(real), k_pen)

    gp_j, grads_j = jax.value_and_grad(penalty)(params)
    k_alpha, k_noise = jax.random.split(k_pen)
    alpha = t(nchw(jax.random.uniform(k_alpha, real.shape, jnp.float32)))
    noise = t(nchw(jax.random.uniform(k_noise, real.shape, jnp.float32)))
    masks = [t(m) for m in jax_masks(D_j, params, stats, k_drop, real.shape)]

    D = dc_t.build(cfg_t, CPU)["discriminator"]
    load_jax_params(D, np_tree(params), np_tree(stats))
    stats_before = {k: v.clone() for k, v in D.state_dict().items() if "running" in k or "num" in k}
    with batch_stats_frozen(D):
        gp = dragan_penalty(lambda x: D(x, masks), t(nchw(real)), alpha, noise)
    gp.backward()
    np.testing.assert_allclose(float(gp.detach()), float(gp_j), rtol=1e-5)
    want = _grads_as_port(D, dc_t.build(cfg_t, CPU)["discriminator"], grads_j, stats)
    for k, v in D.state_dict().items():
        if k in stats_before:
            assert torch.equal(v, stats_before[k]), k
    _assert_grads_close(D, want)


def test_dragan_penalty_draws_alpha_then_noise_and_uses_the_population_std():
    """Element-wise alpha and noise from the generator in that order; std
    with ddof 0; the norm over dim 1 only, at every position (an identity
    critic has dD/dx = 1 everywhere: the norm is sqrt(C))."""
    real = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(7)
    want = torch.Generator().manual_seed(7)
    alpha = torch.rand(real.shape, generator=want)
    noise = torch.rand(real.shape, generator=want)
    got = dragan_penalty(lambda x: x, real, generator=gen)
    assert torch.equal(gen.get_state(), want.get_state())
    assert float(got) == pytest.approx((math.sqrt(3) - 1) ** 2, rel=1e-6)
    seen = []
    dragan_penalty(lambda x: seen.append(x.detach()) or x, real, alpha, noise)
    perturbed = real + 0.5 * float(np.std(real.numpy())) * noise
    torch.testing.assert_close(seen[0], alpha * real + (1 - alpha) * perturbed, rtol=1e-6,
                               atol=1e-6)


def test_wdiv_penalty_matches_jax_on_an_mlp_critic():
    """The penalty and its parameter gradients on the template-A critic,
    differentiated twice through the leaky ReLUs."""
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, (B, SIZE, SIZE, 1)).astype(np.float32)
    fake = rng.uniform(-1, 1, (B, SIZE, SIZE, 1)).astype(np.float32)
    D_j = MLPDiscriminator_j(sigmoid=False)
    params = D_j.init(jax.random.PRNGKey(3), jnp.asarray(real))["params"]

    def penalty(p):
        return wdiv_penalty_j(lambda x: D_j.apply({"params": p}, x), jnp.asarray(real),
                              jnp.asarray(fake), k=wd_j.K, p=wd_j.P)

    gp_j, grads_j = jax.value_and_grad(penalty)(params)
    D = MLPDiscriminator(SIZE * SIZE, sigmoid=False)
    load_jax_params(D, np_tree(params))
    gp = wdiv_penalty(D, t(nchw(real)), t(nchw(fake)), k=wd_t.K, p=wd_t.P)
    gp.backward()
    assert (wd_t.K, wd_t.P) == (2.0, 6.0)
    np.testing.assert_allclose(float(gp.detach()), float(gp_j), rtol=1e-5)
    want = _grads_as_port(D, MLPDiscriminator(SIZE * SIZE, sigmoid=False), grads_j, {})
    _assert_grads_close(D, want)


def _grads_as_port(module, fresh, grads_j, stats):
    load_jax_params(fresh, np_tree(grads_j), np_tree(stats) or None)
    return {k: v for k, v in fresh.state_dict().items()}


def _assert_grads_close(module, want):
    named = dict(module.named_parameters())
    floor = 1e-4 * max(float(want[k].abs().max()) for k in named)
    for k, p in named.items():
        if p.grad is None:  # no path from it to dD/dx: JAX's gradient is 0
            assert not want[k].any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-3, atol=floor,
                                   err_msg=k)


# --- Modules, flags, mains -------------------------------------------------------------


def test_state_dict_keys_are_the_reference_layout():
    """gan/gan.py:38-81 (template A, Sigmoid head), wgan_div's critic without
    it, dragan/dragan.py:45-100 (DCGAN's)."""
    wb = lambda p: [f"{p}.weight", f"{p}.bias"]
    bn = lambda p: wb(p) + [f"{p}.running_mean", f"{p}.running_var", f"{p}.num_batches_tracked"]
    g_a = (wb("model.0") + wb("model.2") + bn("model.3") + wb("model.5") + bn("model.6")
           + wb("model.8") + bn("model.9") + wb("model.11"))
    d_a = wb("model.0") + wb("model.2") + wb("model.4")
    for mod, sigmoid in ((gan_t, True), (wd_t, False)):
        modules = mod.build(mod.Config(), CPU)
        assert list(modules["generator"].state_dict()) == g_a
        assert list(modules["discriminator"].state_dict()) == d_a
        assert isinstance(modules["discriminator"].model[-1], torch.nn.Sigmoid) == sigmoid
    got = {r: list(m.state_dict()) for r, m in dr_t.build(dr_t.Config(), CPU).items()}
    assert got == {r: list(m.state_dict()) for r, m in dc_t.build(dc_t.Config(), CPU).items()}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_config_flags_match_jax(name):
    mod_j, mod_t = TRAINERS[name]
    got = {f.name: (f.default, f.type) for f in dataclasses.fields(mod_t.Config)}
    want = {f.name: (f.default, f.type) for f in dataclasses.fields(mod_j.Config)}
    assert got == want


def run_main(main, argv, out_dir):
    """``main`` with its output under ``out_dir``: the returned state, the
    metric rows, the logged lines' heads and {PNG path: bytes}."""
    state = main(argv + ["--output_dir", str(out_dir), "--metrics_jsonl",
                         str(out_dir / "m.jsonl")])
    rows = [json.loads(line) for line in (out_dir / "m.jsonl").read_text().splitlines()]
    pngs = {}
    for root, _, files in os.walk(out_dir / "images"):
        for f in files:
            path = os.path.join(root, f)
            pngs[os.path.relpath(path, out_dir / "images")] = open(path, "rb").read()
    return state, rows, pngs


def png_size(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


MAIN_ARGV = ["--synthetic_data", "--n_epochs", "1", "--max_batches", "5", "--batch_size", "8",
             "--latent_dim", str(LATENT), "--img_size", str(SIZE), "--sample_interval", "3",
             "--log_interval", "2"]


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_a_five_batch_main_writes_the_rows_and_samples_of_jax(tmp_path, name, capsys):
    """The same metric rows' steps and keys, the same logged batches and the
    same PNG names as the JAX trainer's main; the port's losses finite and
    its grids 5 a row (dragan: one grid an epoch of the whole batch,
    sqrt(8) = 2 a row). wgan_div samples on its G batches, batches_done
    advancing by n_critic."""
    mod_j, mod_t = TRAINERS[name]
    wgan_div = ["--n_critic", "2", "--sample_interval", "2"]
    argv = MAIN_ARGV + (wgan_div if name == "wgan_div" else [])
    got = {}
    for side, main in (("jax", mod_j.main), ("port", lambda a: mod_t.main(a, CPU))):
        _, rows, pngs = run_main(main, argv, tmp_path / side)
        logged = [ln.split("] [D loss")[0] for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith("[Epoch")]
        got[side] = ([(r["step"], sorted(r)) for r in rows], logged, sorted(pngs))
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
            for data in pngs.values():
                assert png_size(data) == ((2 * (SIZE + 2) + 2, 4 * (SIZE + 2) + 2) if name == "dragan"
                                          else (5 * (SIZE + 2) + 2, 2 * (SIZE + 2) + 2))
    assert got["port"] == got["jax"]
    assert got["port"][2] == {"gan": ["0.png", "3.png"], "wgan_div": ["0.png", "2.png", "4.png"],
                              "dragan": ["0.png"]}[name]


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sampling_leaves_the_training_draws_alone(tmp_path, name):
    """A main that samples every batch and one that never samples train the
    same: the same rows and the same final state, generator included."""
    mod_t = TRAINERS[name][1]
    argv = [a for a in MAIN_ARGV]
    argv[argv.index("--sample_interval") + 1] = "1"
    argv += ["--n_critic", "2"] if name == "wgan_div" else []
    runs = []
    for interval, log in (("1", "1"), ("0", "0")):
        a = list(argv)
        a[a.index("--sample_interval") + 1] = interval
        a[a.index("--log_interval") + 1] = log
        state, rows, pngs = run_main(lambda v: mod_t.main(v, CPU), a, tmp_path / interval)
        runs.append((state, rows, pngs))
    (s1, rows1, pngs1), (s0, rows0, pngs0) = runs
    assert rows1 == rows0 and pngs1 and not pngs0
    assert torch.equal(s1.draws.get_state(), s0.draws.get_state())
    for role, m in s1.modules.items():
        other = s0.modules[role].state_dict()
        assert all(torch.equal(v, other[k]) for k, v in m.state_dict().items()), role


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_runs_raise_without_cuda(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TRAINERS[name][1].main(["--synthetic_data", "--output_dir", str(tmp_path)])
