"""One ``--dtype bfloat16`` step of each main-path trainer of the port
(CycleGAN, MUNIT, DCGAN, WGAN-GP) against one jit of the JAX package's step
under ``set_default_compute_dtype(jnp.bfloat16)``, on the CPU, from the same
weights, batch and draws (the JAX step's own, passed in).

bf16 rounds every conv and linear output, and the differences grow with
depth: a bf16 and a float32 step of the same model differ by up to a
quarter of a generator's gradient norm here. So each side is held at that
scale, measured on the JAX side: each loss and each gradient to

    |port_bf16 - jax_bf16| <= FACTOR * |jax_bf16 - jax_fp32| + atol * |jax_fp32|

with FACTOR = 2, a gradient as the vector of all of one optimizer's
parameters (for a module) in the port's layout, |.| its Euclidean norm, and
atol GRAD_ATOL = 1e-3; a loss as a number, with atol LOSS_ATOL = 2^-6, two
bf16 ulps: one scalar's bf16-float32 difference on the JAX side can vanish
by chance (CycleGAN's d_loss: 5e-5 of 1.07, where its outputs moved by up
to 1.3e-2). The JAX gradients are the ones its
optimizers applied (``adam_torch`` recording them), the port's each
parameter's ``.grad`` after the step. The port's losses are float32, as
JAX's are here. WGAN-GP's JAX penalty is the same float32 closed form as the
port's (``TPUGAN_PALLAS_GP=xla``): the interpolate is float32 on both sides.
After the step every output of the port is in the dtype JAX gives it and
every parameter is float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_port_cyclegan as cg_test
import test_torch_port_munit as mu_test
from test_torch_port_unet_im2im import jax_initial_state, ordered
from test_torch_port_critic_rest import (  # noqa: F401 (autouse fixture)
    Spec,
    _recording,
    as_port,
    jax_masks,
    one_torch_thread,
    port_modules,
    record_updates,
    t,
)

from tpugan.models import _template_b as tb_j
from tpugan.models import cyclegan as cg_j
from tpugan.models import dcgan as dc_j
from tpugan.models import munit as mu_j
from tpugan.models import wgan_gp as wg_j
from tpugan.nn import layers as layers_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import cyclegan as cg_t
from tpugan_torch.models import dcgan as dc_t
from tpugan_torch.models import munit as mu_t
from tpugan_torch.models import wgan_gp as wg_t
from tpugan_torch.nn import layers as layers_t
from tpugan_torch.ops import mlp_gp

CPU = torch.device("cpu")
B, LATENT, SIZE = 8, 16, 16
FACTOR, GRAD_ATOL, LOSS_ATOL = 2.0, 1e-3, 2.0 ** -6


@pytest.fixture(autouse=True)
def float32_around():
    layers_j.set_default_compute_dtype(None)
    layers_t.set_default_compute_dtype(None)
    yield
    layers_j.set_default_compute_dtype(None)
    layers_t.set_default_compute_dtype(None)


def _check(what, port, jb, jf, atol=GRAD_ATOL):
    """The rule of the module docstring for one loss or one gradient."""
    port, jb, jf = (np.asarray(a, np.float64).ravel() for a in (port, jb, jf))
    d, scale = np.linalg.norm(port - jb), np.linalg.norm(jb - jf)
    print(f"{what}: |port - jax_bf16| {d:.4g}, |jax_bf16 - jax_fp32| {scale:.4g}, "
          f"|jax_fp32| {np.linalg.norm(jf):.4g}")
    assert d <= FACTOR * scale + atol * np.linalg.norm(jf), (
        f"{what}: |port - jax_bf16| {d:.4g}, |jax_bf16 - jax_fp32| {scale:.4g}, "
        f"|jax_fp32| {np.linalg.norm(jf):.4g}")


def _vector(grads: dict, params) -> np.ndarray:
    """One module's gradients in the order of its parameters."""
    return np.concatenate([grads[k].numpy().ravel() for k, _ in params])


def _jax_im2im_steps(mod_j, cfg, batch):
    """One jit of the JAX step under bf16 and one under float32 from one
    initial state (its parameters do not depend on the compute dtype; made
    under jit, ``jax_initial_state``), the optimizers recording their
    gradients: (the initial state, its params' skeleton in init order,
    {dtype: (step out, {optimizer: grads})})."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod_j, "adam_torch", _recording(mod_j.adam_torch))
        modules = mod_j.build(cfg)
        state, skeleton = jax_initial_state(mod_j, cfg, modules)
        for dtype in (jnp.bfloat16, None):
            layers_j.set_default_compute_dtype(dtype)
            try:
                new_state, out = jax.jit(mod_j.make_step(cfg, modules, steps_per_epoch=10))(
                    state, *batch)
            finally:
                layers_j.set_default_compute_dtype(None)
            got[dtype] = ({k: np.asarray(v) for k, v in out.items()},
                          {name: st["g"] for name, st in new_state.opt_state.items()})
    return state, skeleton["params"], got


def _im2im_case(mod_j, mod_t, test_mod, cfg_j, cfg_t, batch, step_kw=lambda state: {}):
    """Both JAX steps and the port's bf16 step, ``step_kw(jax_state)`` its
    draws; the checks of the docstring on every loss and every module's
    gradient."""
    state, skeleton, got = _jax_im2im_steps(mod_j, cfg_j, batch)
    (out_b, grads_b), (out_f, grads_f) = got[jnp.bfloat16], got[None]
    params0 = ordered(state.params, skeleton)
    layers_t.set_default_compute_dtype(torch.bfloat16)
    modules = mod_t.build(cfg_t, CPU)
    for name in mod_t.MODULES:
        load_jax_params(modules[name], params0[name])
    st = mod_t.create_state(cfg_t, modules, CPU)
    _, out_t = mod_t.make_step(cfg_t, modules, CPU)(
        st, *(torch.from_numpy(x) for x in batch), **step_kw(state))
    assert {v.dtype for v in out_t.values()} == {torch.float32}
    assert {p.dtype for m in modules.values() for p in m.parameters()} == {torch.float32}
    assert set(out_t) == set(out_b)
    for k in out_b:
        _check(k, float(out_t[k]), out_b[k], out_f[k], LOSS_ATOL)
    for opt_name, tree in grads_b.items():
        names = [opt_name] if opt_name in modules else list(tree)
        for name in names:
            sub_b = tree if opt_name in modules else tree[name]
            sub_f = grads_f[opt_name] if opt_name in modules else grads_f[opt_name][name]
            as_t = lambda g: test_mod._as_torch(name, ordered(g, skeleton[name]))
            params = list(modules[name].named_parameters())
            got = np.concatenate([p.grad.numpy().ravel() for _, p in params])
            _check(name, got, _vector(as_t(sub_b), params), _vector(as_t(sub_f), params))


def test_cyclegan_bf16_step_matches_jax():
    """32px, one residual block, batch 1; the replay buffers make no draw in
    the first step. The generators' outputs are bf16 on both sides."""
    _im2im_case(cg_j, cg_t, cg_test, cg_test._cfg(cg_j), cg_test._cfg(cg_t), cg_test._batch())


def test_munit_bf16_step_matches_jax():
    """64px, dim 8, one residual block, batch 1, with JAX's style codes: the
    AdaIN sites take bf16 maps and the bf16 style MLP's weights."""
    cfg_j, cfg_t = mu_j.Config(**mu_test.SMALL), mu_t.Config(**mu_test.SMALL)
    styles = lambda state: {"styles": [torch.from_numpy(np.asarray(s))
                                       for s in mu_test._styles(state, cfg_j, 1)]}
    _im2im_case(mu_j, mu_t, mu_test, cfg_j, cfg_t, mu_test._batch(), styles)


def _draws_template_b(rng, cfg, shape):
    _, k_z, k1, k2, k3 = jax.random.split(rng, 5)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim)))}, [k1, k2, k3]


def _draws_wgan_gp(rng, cfg, shape):
    _, k_z, k_pen = jax.random.split(rng, 3)
    return {"z": t(jax.random.normal(k_z, (shape[0], cfg.latent_dim))),
            "alpha": t(jax.random.uniform(k_pen, (shape[0], 1, 1, 1), jnp.float32))}, []


SPECS = {
    "dcgan": Spec(dc_j, dc_t, _draws_template_b, {"generator": 1, "discriminator": 3}),
    "wgan_gp": Spec(wg_j, wg_t, _draws_wgan_gp, {"generator": 2}, critic=True),
}


def _jax_template_steps(spec, cfg, imgs, labels):
    """The JAX step (or d_step and g_step) under bf16 and under float32 from
    one initial state made under jit, the optimizers recording their
    gradients: (state0, skeleton, {dtype: (out, state1)})."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        for m in {spec.mod_j, tb_j}:
            if hasattr(m, "adam_torch"):
                mp.setattr(m, "adam_torch", _recording(m.adam_torch))
        mods = spec.mod_j.build(cfg)
        state0, skeleton = jax_initial_state(spec.mod_j, cfg, mods)
        for dtype in (jnp.bfloat16, None):
            layers_j.set_default_compute_dtype(dtype)
            try:
                if spec.critic:
                    d_step, g_step = spec.mod_j.make_steps(cfg, mods)
                    s1, d_out = jax.jit(d_step)(state0, imgs, labels)
                    state1, g_out = jax.jit(g_step)(s1, d_out["z"])
                    out = {**d_out, **g_out}
                else:
                    state1, out = jax.jit(spec.mod_j.make_step(cfg, mods))(state0, imgs, labels)
            finally:
                layers_j.set_default_compute_dtype(None)
            got[dtype] = (out, state1)
    return mods, state0, skeleton, got


@pytest.mark.parametrize("name", sorted(SPECS))
def test_template_bf16_step_matches_jax(name, monkeypatch):
    """DCGAN at 16px, batch 8, with JAX's z and Dropout2d masks; WGAN-GP's
    d_step and g_step at batch 8 with JAX's z and alpha, the closed-form GP
    on both sides. Each optimizer's recorded gradients, by module."""
    monkeypatch.setenv("TPUGAN_PALLAS_GP", "xla")
    spec = SPECS[name]
    kw = dict(batch_size=B, latent_dim=LATENT, img_size=SIZE, synthetic_data=True)
    cfg_j, cfg_t = spec.mod_j.Config(**kw), spec.mod_t.Config(**kw)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (B, SIZE, SIZE, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, B).astype(np.int32)
    mods, state0, skeleton, got = _jax_template_steps(spec, cfg_j, imgs, labels)
    params0 = ordered(state0.params, skeleton["params"])
    stats0 = ordered(state0.model_state or {}, skeleton["stats"])
    draws, keys = spec.draws(state0.rng, cfg_j, imgs.shape)
    if keys:
        draws["masks"] = [[t(m) for m in jax_masks(mods["discriminator"],
                                                    params0["discriminator"],
                                                    stats0.get("discriminator"), k, imgs.shape)]
                          for k in keys]
    layers_t.set_default_compute_dtype(torch.bfloat16)
    modules = port_modules(spec, cfg_t, params0, stats0)
    state = spec.mod_t.create_state(cfg_t, modules, CPU)
    rec = record_updates(state)
    if spec.critic:
        d_step, g_step = spec.mod_t.make_steps(cfg_t, state)
        assert mlp_gp.extract_mlp_critic(modules["discriminator"]) is not None
        state, d_out = d_step(state, t(imgs), None, **draws)
        state, g_out = g_step(state, d_out["z"])
        out_t = {**d_out, **g_out}
    else:
        state, out_t = spec.mod_t.make_step(cfg_t, state)(state, t(imgs), t(labels), **draws)
    (out_b, state_b), (out_f, state_f) = got[jnp.bfloat16], got[None]
    for k in ("d_loss", "g_loss"):
        assert out_t[k].dtype == torch.float32
        _check(k, float(out_t[k]), np.asarray(out_b[k]), np.asarray(out_f[k]), LOSS_ATOL)
    if "gen_imgs" in out_t:
        assert out_t["gen_imgs"].dtype == torch.bfloat16
    assert {p.dtype for m in modules.values() for p in m.parameters()} == {torch.float32}
    for opt_name, calls in rec.items():
        (call,) = calls
        keys = [k for (role, k) in call if role == opt_name]
        want = {dt: as_port(spec, cfg_t, opt_name, ordered(
            st.opt_state[opt_name]["g"], skeleton["params"][opt_name]), stats0)
            for dt, (_, st) in got.items()}
        vec = lambda d: np.concatenate([d[k].numpy().ravel() for k in keys])
        got_t = np.concatenate([call[opt_name, k][1].numpy().ravel() for k in keys])
        _check(opt_name, got_t, vec(want[jnp.bfloat16]), vec(want[None]))
