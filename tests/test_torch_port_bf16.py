"""``--dtype bfloat16`` in the port against the JAX package's mixed precision
(``tpugan/nn/layers.py:33-52``), on the CPU: the plain bf16 versions of the
instance-norm and AdaIN kernels, the layers, the parameter trees, and one
bf16 batch of every entry's ``main``. The four main-path steps are in
``tests/test_torch_port_bf16_steps.py``.

What each side is held to:

- Plain versions, same bf16 inputs: the port widens to float32, computes in
  float32 and rounds each output to bf16 once; JAX's XLA branch
  (``instance_norm_xla``, ``adain``) computes one-pass float32 statistics
  and normalizes in bf16 with a bf16 mean and scale. Both are held to the
  float64 truth of the same function on the same bf16 values: the port's
  largest error must be no larger than JAX's plus one bf16 ulp of the
  truth's largest magnitude. The forward outputs also agree within one ulp
  of that magnitude.
- Layers: output dtypes as JAX's type promotion gives them, values within
  two bf16 ulps of the output's largest magnitude (both sides round each
  output to bf16 after float32 sums in different orders), parameters and
  norm buffers float32.
- Losses stay float32 on the port's side (``tpugan_torch/losses``): they
  are at least as accurate as JAX's, where a bf16 prediction against a
  Python scalar may stay bf16.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

import chip_smoke
from tpugan.nn import layers as layers_j
from tpugan.nn.resnet import ResNet18Trunk as ResNet18Trunk_j
from tpugan.nn.style import adain as adain_j
from tpugan.ops.pallas_kernels import instance_norm_act as in_act_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import registry
from tpugan_torch.nn import layers as layers_t
from tpugan_torch.nn.resnet import ResNet18Trunk
from tpugan_torch.ops.adain import adain_bwd_ref, adain_fwd_ref
from tpugan_torch.ops.instance_norm import in_act_bwd_ref, in_act_fwd_ref

CPU = torch.device("cpu")
EPS = 1e-5
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def float32_around():
    """Both packages' compute dtype back to float32 before and after each
    test (``tests/test_mixed_precision.py:12-16``)."""
    layers_j.set_default_compute_dtype(None)
    layers_t.set_default_compute_dtype(None)
    yield
    layers_j.set_default_compute_dtype(None)
    layers_t.set_default_compute_dtype(None)


def _both_bf16():
    layers_j.set_default_compute_dtype(jnp.bfloat16)
    layers_t.set_default_compute_dtype(BF16)


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a, np.float64).transpose(0, 2, 3, 1))


def _ulp(t) -> float:
    return float(chip_smoke.bf16_ulp(torch.as_tensor(np.abs(np.asarray(t, np.float64)).max())))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16_maps(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    maps = [(rng.normal(size=shape) * 2 + 0.5).astype(np.float32)]
    maps += [rng.normal(size=shape).astype(np.float32) for _ in range(n - 1)]
    return [torch.from_numpy(m).to(BF16) for m in maps]


def _as_jax(t):
    """A bf16 NCHW tensor as a bf16 NHWC JAX array of the same values."""
    return jnp.asarray(_nhwc(t.float().numpy()), jnp.bfloat16)


# --- plain versions ------------------------------------------------------------


@pytest.mark.parametrize("slope", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 4, 17, 5), (2, 2, 32, 32)])
def test_in_plain_bf16_against_jax_and_float64(shape, slope):
    x, g = _bf16_maps(shape, 0)
    y_t, mean, rstd = in_act_fwd_ref(x, EPS, slope)
    dx_t = in_act_bwd_ref(g, x, mean, rstd, slope)
    assert (y_t.dtype, dx_t.dtype, mean.dtype, rstd.dtype) == (BF16, BF16) + (torch.float32,) * 2
    y_j, vjp = jax.vjp(lambda v: in_act_j(v, slope, EPS), _as_jax(x))
    (dx_j,) = vjp(_as_jax(g))
    assert y_j.dtype == dx_j.dtype == jnp.bfloat16
    x64, g64 = x.double(), g.double()
    y64, m64, r64 = in_act_fwd_ref(x64, EPS, slope)
    dx64 = in_act_bwd_ref(g64, x64, m64, r64, slope)
    for port, jx, truth in ((y_t, y_j, y64), (dx_t, dx_j, dx64)):
        want = _nhwc(truth.numpy())
        err_t = np.abs(_nhwc(port.double().numpy()) - want).max()
        err_j = np.abs(np.asarray(jx, np.float64) - want).max()
        assert err_t <= err_j + _ulp(want), (err_t, err_j)
    np.testing.assert_array_less(
        np.abs(_nhwc(y_t.double().numpy()) - np.asarray(y_j, np.float64)), _ulp(y64) * 1.0001)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 4, 17, 5)])
def test_adain_plain_bf16_against_jax_and_float64(shape):
    x, g = _bf16_maps(shape, 1)
    rng = np.random.default_rng(2)
    w = torch.from_numpy((1 + 0.3 * rng.normal(size=shape[:2])).astype(np.float32)).to(BF16)
    b = torch.from_numpy((0.3 * rng.normal(size=shape[:2])).astype(np.float32)).to(BF16)
    y_t, mean, rstd = adain_fwd_ref(x, w, b, EPS)
    grads_t = adain_bwd_ref(g, x, w, mean, rstd)
    assert {t.dtype for t in (y_t, *grads_t)} == {BF16}
    wj, bj = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (w, b))
    y_j, vjp = jax.vjp(lambda v, ww, bb: adain_j(v, ww, bb, EPS), _as_jax(x), wj, bj)
    grads_j = vjp(_as_jax(g))
    assert {a.dtype for a in (y_j, *grads_j)} == {jnp.dtype(jnp.bfloat16)}
    x64, w64, b64, g64 = (t.double() for t in (x, w, b, g))
    y64, m64, r64 = adain_fwd_ref(x64, w64, b64, EPS)
    truths = (y64, *adain_bwd_ref(g64, x64, w64, m64, r64))
    for port, jx, truth in zip((y_t, *grads_t), (y_j, *grads_j), truths):
        if truth.ndim == 4:
            port, truth = _nhwc(port.double().numpy()), _nhwc(truth.numpy())
        else:
            port, truth = port.double().numpy(), truth.numpy()
        err_t = np.abs(port - truth).max()
        err_j = np.abs(np.asarray(jx, np.float64) - truth).max()
        assert err_t <= err_j + _ulp(truth), (err_t, err_j)


# --- layers --------------------------------------------------------------------


def _layer_case(kind):
    """(JAX module, port layer, NHWC input) of one computing layer."""
    rng = np.random.default_rng(3)
    if kind == "linear":
        return (layers_j.Linear(24), layers_t.Linear(40, 24),
                rng.normal(size=(6, 40)).astype(np.float32))
    x = rng.normal(size=(2, 12, 12, 16)).astype(np.float32)
    if kind == "conv3":
        return layers_j.Conv(24, 3, 1, 1), layers_t.Conv2d(16, 24, 3, 1, 1), x
    if kind == "conv4s2":
        return layers_j.Conv(24, 4, 2, 1), layers_t.Conv2d(16, 24, 4, 2, 1), x
    return (layers_j.ConvTranspose(24, 4, 2, 1, init_mode="normal02"),
            layers_t.ConvTranspose2d(16, 24, 4, 2, 1), x)


@pytest.mark.parametrize("kind", ["conv3", "conv4s2", "convT", "linear"])
def test_computing_layers_run_in_bf16_as_flax(kind):
    """Conv2d, ConvTranspose2d and Linear cast input, weight and bias to
    bf16 and return bf16, as flax does; the float32 parameters take float32
    gradients; the float32 output stays what it was."""
    m_j, m_t, x = _layer_case(kind)
    params = m_j.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    load_jax_params(m_t, _np(params))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy() if x.ndim == 4 else x)
    y32 = m_t(xt).detach()
    _both_bf16()
    y_j = m_j.apply({"params": params}, jnp.asarray(x))
    y_t = m_t(xt.requires_grad_())
    assert y_j.dtype == jnp.bfloat16 and y_t.dtype == BF16
    want = np.asarray(y_j, np.float32)
    got = y_t.detach().float().numpy()
    got = got.transpose(0, 2, 3, 1) if got.ndim == 4 else got
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * _ulp(want))
    y_t.float().sum().backward()
    assert {p.grad.dtype for p in m_t.parameters()} == {torch.float32}
    assert xt.grad.dtype == torch.float32
    layers_t.set_default_compute_dtype(None)
    assert torch.equal(m_t(xt.detach()), y32)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_on_bf16_keeps_float32_statistics(train):
    """BatchNorm2d on a bf16 map (``tpugan/nn/layers.py:455-509``): bf16
    out, within two bf16 ulps of the JAX layer's folded bf16 normalize;
    float32 running buffers within 1e-3 relative of JAX's (both from float32
    statistics of the same bf16 values; the unbiased variance)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=(4, 6, 6, 8)) * 2 + 0.5).astype(np.float32)).to(BF16)
    bn_j = layers_j.BatchNorm(eps=0.8)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    variables = bn_j.init(jax.random.PRNGKey(0), xj, train=True)
    params = {"scale": jnp.asarray(rng.normal(1.0, 0.2, 8), jnp.float32),
              "bias": jnp.asarray(rng.normal(0.0, 0.3, 8), jnp.float32)}
    stats = jax.tree_util.tree_map(lambda v: v + 0.25, variables["batch_stats"])
    y_j, mut = bn_j.apply({"params": params, "batch_stats": stats}, xj, train=train,
                          mutable=["batch_stats"])
    bn_t = layers_t.BatchNorm2d(8, 0.8)
    load_jax_params(bn_t, _np(params), _np(stats))
    bn_t.train(train)
    y_t = bn_t(x.permute(0, 3, 1, 2))
    assert y_j.dtype == jnp.bfloat16 and y_t.dtype == BF16
    want = np.asarray(y_j, np.float32)
    np.testing.assert_allclose(y_t.detach().float().permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=2 * _ulp(want))
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        buf = getattr(bn_t, name)
        assert buf.dtype == torch.float32 and mut["batch_stats"][key].dtype == jnp.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(mut["batch_stats"][key]), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("tracked,train", [(False, True), (True, True), (True, False)])
def test_affine_instance_norm_promotes_to_float32(tracked, train):
    """The affine IN on a bf16 map: the kernel's bf16 output times the
    float32 scale is float32 on both sides (JAX's promotion), within two
    bf16 ulps; a tracked IN's buffers stay float32 and follow JAX's; in eval
    mode the buffers promote the output to float32 too."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=(2, 8, 8, 4)) * 2 + 0.5).astype(np.float32)).to(BF16)
    in_j = layers_j.InstanceNorm(affine=True, track_running_stats=tracked)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    variables = in_j.init(jax.random.PRNGKey(0), xj)
    params = {"scale": jnp.asarray(rng.normal(1.0, 0.2, 4), jnp.float32),
              "bias": jnp.asarray(rng.normal(0.0, 0.3, 4), jnp.float32)}
    stats = jax.tree_util.tree_map(lambda v: v + 0.5, variables.get("batch_stats", {}))
    y_j, mut = in_j.apply({"params": params, "batch_stats": stats}, xj, train=train,
                          mutable=["batch_stats"])
    in_t = layers_t.InstanceNorm(4, affine=True, track_running_stats=tracked)
    with torch.no_grad():
        in_t.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
        in_t.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        if tracked:
            in_t.running_mean.copy_(torch.from_numpy(np.asarray(stats["mean"])))
            in_t.running_var.copy_(torch.from_numpy(np.asarray(stats["var"])))
    in_t.train(train)
    y_t = in_t(x.permute(0, 3, 1, 2))
    assert y_j.dtype == jnp.float32 and y_t.dtype == torch.float32
    want = np.asarray(y_j)
    np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=2 * _ulp(want))
    if tracked:
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            buf = getattr(in_t, name)
            assert buf.dtype == torch.float32
            np.testing.assert_allclose(buf.numpy(), np.asarray(mut["batch_stats"][key]),
                                       rtol=1e-2, atol=1e-3)


def test_small_layers_keep_jax_dtypes_on_bf16():
    """LayerNormSpatial and PReLU promote a bf16 input to float32 through
    their float32 parameters, as the JAX layers do; Dropout keeps bf16 (its
    0/1 mask is exact in bf16)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 6, 6, 4)).astype(np.float32)).to(BF16)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    xt = x.permute(0, 3, 1, 2)
    ln_j = layers_j.LayerNormSpatial()
    v = ln_j.init(jax.random.PRNGKey(0), xj)
    ln_t = layers_t.LayerNormSpatial(4)
    with torch.no_grad():
        ln_t.gamma.copy_(torch.from_numpy(np.asarray(v["params"]["gamma"])))
    pr_j, pr_t = layers_j.PReLU(), layers_t.PReLU()
    vp = pr_j.init(jax.random.PRNGKey(0), xj)
    for m_j, variables, m_t in ((ln_j, v, ln_t), (pr_j, vp, pr_t)):
        y_j, y_t = m_j.apply(variables, xj), m_t(xt)
        assert y_j.dtype == jnp.float32 and y_t.dtype == torch.float32
        want = np.asarray(y_j)
        np.testing.assert_allclose(y_t.detach().permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=2 * _ulp(want))
    drop = layers_t.Dropout(0.5)
    mask = drop.draw_mask(xt.shape, torch.Generator().manual_seed(0))
    y = drop(xt, mask)
    assert y.dtype == BF16 and torch.equal(y, xt * 2 * mask.to(BF16))


def test_resnet18_trunk_stays_float32():
    """The trunk's convs are raw (flax ``nn.Conv`` without a dtype in the
    JAX package): under bf16 both sides run it in float32 on a bf16 input,
    and the port's output is its float32 output bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    m_j = ResNet18Trunk_j()
    trunk = ResNet18Trunk().eval()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(BF16)
    y32 = trunk(xt.float())
    _both_bf16()
    xj = jnp.asarray(xt.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)
    y_j = jax.eval_shape(lambda v: m_j.apply(m_j.init(jax.random.PRNGKey(0), v, train=False), v,
                                             train=False), xj)
    y_t = trunk(xt)
    assert y_j.dtype == jnp.float32 and y_t.dtype == torch.float32
    assert torch.equal(y_t, y32)


@pytest.mark.parametrize("name", ["cyclegan", "munit", "dcgan", "wgan_gp"])
def test_param_tree_and_state_dict_are_the_same_under_both_dtypes(name):
    """The JAX param tree initialized under bf16 has the float32 one's
    structure, shapes and float32 leaves (traced, ``jax.eval_shape``); the
    port's modules built under bf16 have the same ``state_dict`` keys,
    shapes and float32 values as under float32, and ``load_jax_params``
    pairs that tree with them under bf16."""
    import importlib

    mod_j = importlib.import_module(f"tpugan.models.{name}")
    small = {"cyclegan": dict(img_height=32, img_width=32, n_residual_blocks=1),
             "munit": dict(img_height=64, img_width=64, dim=8, n_residual=1),
             "dcgan": dict(img_size=16, latent_dim=8), "wgan_gp": dict(latent_dim=8)}[name]
    cfg_j = mod_j.Config(synthetic_data=True, **small)
    mods = mod_j.build(cfg_j)
    if name in ("cyclegan", "munit"):
        create = lambda: mod_j.create_state(cfg_j, mods, steps_per_epoch=2)
    else:
        create = lambda: mod_j.create_state(cfg_j, mods)
    init = lambda: (lambda st: (st.params, getattr(st, "model_state", None) or {}))(create())
    trees = {}
    for dt in (None, jnp.bfloat16):
        layers_j.set_default_compute_dtype(dt)
        trees[dt] = jax.eval_shape(init)
    layers_j.set_default_compute_dtype(None)
    (a, _), (b, stats) = trees[None], trees[jnp.bfloat16]
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for u, v in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert u.shape == v.shape and u.dtype == v.dtype == jnp.float32
    mod_t = registry.get(name)
    cfg_t = mod_t.Config(synthetic_data=True, **small)
    sds = {}
    for dt in (None, BF16):
        layers_t.set_default_compute_dtype(dt)
        modules = mod_t.build(cfg_t, CPU)
        sds[dt] = {k: m.state_dict() for k, m in modules.items()}
    for role in sds[None]:
        s32, s16 = sds[None][role], sds[BF16][role]
        assert list(s32) == list(s16)
        for key in s32:
            assert s32[key].shape == s16[key].shape and s32[key].dtype == s16[key].dtype
            assert not s16[key].is_floating_point() or s16[key].dtype == torch.float32
            assert torch.equal(s32[key], s16[key]), (role, key)
    paired = [role for role in modules if role in b]
    assert paired
    zeros = lambda tree: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    for role in paired:
        load_jax_params(modules[role], zeros(b[role]), zeros(stats.get(role) or {}) or None)


# --- every entry takes the flag ------------------------------------------------

# The smallest size of each trainer for one bf16 batch with a sample and a
# checkpoint. pix2pix (256px) and dualgan (128px) are left out for time
# (15 s and 11 s of the 62 s all 32 take on one thread): discogan covers the
# U-Net ConvTranspose2d, stargan the affine IN, the critic family's
# BatchNorm1d MLPs the penalty's float32 interpolate.
_MNIST = ["--batch_size", "4", "--img_size", "16", "--latent_dim", "8"]
MAIN_ARGV = {
    "aae": ["--batch_size", "4", "--img_size", "16", "--latent_dim", "4"],
    **{n: _MNIST for n in ("acgan", "began", "bgan", "cgan", "dcgan", "dragan", "ebgan", "gan",
                           "infogan", "lsgan", "relativistic_gan", "sgan", "softmax_gan", "wgan",
                           "wgan_div", "wgan_gp")},
    "cluster_gan": ["--batch_size", "4", "--latent_dim", "8"],
    "cogan": ["--batch_size", "4"],
    "pixelda": ["--batch_size", "4", "--n_residual_blocks", "1"],
    "bicyclegan": ["--batch_size", "2", "--latent_dim", "2"],
    "ccgan": ["--batch_size", "2", "--img_size", "128"],
    "context_encoder": ["--batch_size", "2", "--img_size", "32", "--mask_size", "16"],
    "cyclegan": ["--img_height", "32", "--img_width", "32", "--n_residual_blocks", "1"],
    "discogan": ["--batch_size", "2"],
    "munit": ["--img_height", "64", "--img_width", "64", "--dim", "4", "--n_residual", "1"],
    "stargan": ["--img_height", "64", "--img_width", "64", "--residual_blocks", "1",
                "--batch_size", "2", "--n_critic", "1"],
    "unit": ["--img_height", "32", "--img_width", "32", "--dim", "8"],
    "srgan": ["--batch_size", "2", "--hr_height", "32", "--hr_width", "32"],
    "esrgan": ["--batch_size", "2", "--hr_height", "32", "--hr_width", "32",
               "--residual_blocks", "1", "--warmup_batches", "0"],
}


def _check_checkpoints(out_dir) -> list:
    paths = sorted(glob.glob(os.path.join(out_dir, "saved_models", "**", "*.pth"),
                             recursive=True))
    for path in paths:
        for key, v in torch.load(path, map_location="cpu", weights_only=True).items():
            if v.is_floating_point():
                assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), (path, key)
    return paths


@pytest.mark.parametrize("name", sorted(MAIN_ARGV))
def test_every_trainer_takes_one_bf16_batch(tmp_path, name, capsys):
    """``main(argv + ["--dtype", "bfloat16"], "cpu")``: finite losses, the
    compute dtype set, float32 parameters and checkpoints."""
    mod = registry.get(name)
    fields = {f.name for f in dataclasses.fields(mod.Config)}
    argv = MAIN_ARGV[name] + ["--synthetic_data", "--n_epochs", "1", "--max_batches", "1",
                              "--dtype", "bfloat16", "--output_dir", str(tmp_path),
                              "--metrics_jsonl", str(tmp_path / "m.jsonl")]
    argv += ["--sample_interval", "1"] if "sample_interval" in fields else []
    argv += ["--checkpoint_interval", "1"] if "checkpoint_interval" in fields else []
    state = mod.main(argv, CPU)
    capsys.readouterr()
    assert layers_t.compute_dtype() is BF16
    rows = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0]
    assert all(np.isfinite(v) for v in rows[0].values()), rows[0]
    modules = getattr(state, "modules", None) or {}
    assert {p.dtype for m in modules.values() for p in m.parameters()} <= {torch.float32}
    paths = _check_checkpoints(tmp_path)
    assert paths or "checkpoint_interval" not in fields


def test_test_on_image_takes_the_flag(tmp_path, capsys):
    """esrgan's bf16 generator checkpoint through ``test_on_image --dtype
    bfloat16``: a 4x PNG of the float32 output of the bf16 forward."""
    from PIL import Image

    from tpugan_torch.models import esrgan, test_on_image

    esrgan.main(MAIN_ARGV["esrgan"] + [
        "--synthetic_data", "--n_epochs", "1", "--max_batches", "1", "--checkpoint_interval",
        "1", "--dtype", "bfloat16", "--output_dir", str(tmp_path)], CPU)
    (ckpt,) = [p for p in _check_checkpoints(tmp_path) if "generator" in p]
    img = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (16, 16, 3), np.uint8)).save(img)
    out = test_on_image.main(["--image_path", str(img), "--checkpoint_model", ckpt,
                              "--residual_blocks", "1", "--dtype", "bfloat16", "--output_dir",
                              str(tmp_path)], CPU)
    capsys.readouterr()
    assert Image.open(out).size == (4 * 16 + 4, 4 * 16 + 4)
