"""The layers and blocks of the port's im2im slices against the JAX package
on the CPU: ConvTranspose2d, affine InstanceNorm, UNetDown and UNetUp at
narrow widths with each option, the generalised PatchGAN, and
``resize_bilinear``. The full steps of the trainers that use them are in
``tests/test_torch_port_unet_im2im.py`` and
``tests/test_torch_port_inpainting.py``, whose harness this file shares.

Each block goes through the JAX module and the port's from the same
``init``, with the JAX module's dropout masks read off its forward and
passed in; the gradients are those of sum(output * cot) for a random cot.
Tolerances, float32 on both sides: outputs 1e-5 absolute; input gradients
1e-4 relative plus 1e-5 of their largest; parameter gradients 1e-4
relative plus 1e-5 of the module's largest (a bias that feeds a norm has a
true gradient of 0); BatchNorm running statistics 1e-4 relative and 1e-6
absolute; ``resize_bilinear`` 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_unet_im2im import (
    key_order,
    mask_groups,
    nchw,
    nhwc,
    ordered,
    recording_masks,
)

from tpugan.nn.im2im import PatchGAN as PatchGAN_j
from tpugan.nn.im2im import UNetDown as UNetDown_j
from tpugan.nn.im2im import UNetUp as UNetUp_j
from tpugan.nn.layers import ConvTranspose as ConvTranspose_j
from tpugan.nn.layers import InstanceNorm as InstanceNorm_j
from tpugan.ops.image import resize_bilinear as resize_bilinear_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.nn.im2im import PatchGAN, UNetDown, UNetUp
from tpugan_torch.nn.layers import ConvTranspose2d, InstanceNorm
from tpugan_torch.ops.image import resize_bilinear


def _jax_vjp(module, variables, args, cot, train, rngs=None, mutable=False):
    """The output of ``module`` and the gradients of sum(output * cot) with
    respect to its params and its first argument; the dropout masks drawn."""

    def f(params, x):
        out = module.apply({**variables, "params": params}, x, *args[1:], rngs=rngs,
                           mutable=["batch_stats"] if mutable else False, **train)
        out = out[0] if mutable else out
        return jnp.sum(out * cot), out

    run = recording_masks(lambda p, x: jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x))
    ((_, out), (gp, gx)), masks = run(variables["params"], args[0])
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx), masks


def _check_layer(module_j, module_t, args, seed=0, rngs=None, mutable=False, train=True):
    """``module_t`` loaded with ``module_j``'s init against it: output 1e-5
    absolute; input and parameter gradients 1e-4 relative plus 1e-5 of the
    largest absolute (the parameters': of the module's largest; a bias that
    feeds a norm has a true gradient of 0)."""
    rng = np.random.default_rng(seed)
    args = [jnp.asarray(a) for a in args]
    train = {"train": True} if train else {}
    skeletons = {}

    def init(key, *a):
        v = module_j.init(key, *a, **({"train": False} if train else {}))
        skeletons.update({k: key_order(v[k]) for k in v})
        return v

    variables = init(jax.random.PRNGKey(seed), *args)
    out = jax.eval_shape(lambda v, *a: module_j.apply(
        v, *a, rngs=rngs, mutable=["batch_stats"] if mutable else False, **train), variables, *args)
    out = out[0] if mutable else out
    cot = jnp.asarray(rng.normal(size=out.shape).astype(np.float32))
    out_j, gp, gx, masks = _jax_vjp(module_j, dict(variables), args, cot, train, rngs, mutable)
    skeleton = skeletons["params"]
    stats = ordered(variables["batch_stats"], skeletons["batch_stats"]) if mutable else None
    load_jax_params(module_t, ordered(variables["params"], skeleton), stats)
    xs = [nchw(a).requires_grad_(i == 0) for i, a in enumerate(args)]
    kw = {"masks": iter(mask_groups(masks, 1)[0])} if masks else {}
    y = module_t(*xs, **kw)
    running = {k: v.clone() for k, v in module_t.state_dict().items() if "running" in k}
    np.testing.assert_allclose(nhwc(y), out_j, atol=1e-5)
    (y * nchw(cot)).sum().backward()

    np.testing.assert_allclose(nhwc(xs[0].grad), gx, rtol=1e-4, atol=1e-5 * np.abs(gx).max(),
                               err_msg="input")
    got = {k: v.grad.numpy() for k, v in module_t.named_parameters()}
    load_jax_params(module_t, ordered(gp, skeleton), stats)
    want = {k: p.detach().numpy() for k, p in module_t.named_parameters()}
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=floor, err_msg=k)
    return len(masks), running


@pytest.mark.parametrize("hw", [8, 32])
def test_conv_transpose_matches_jax(hw):
    """torch's transposed convolution against ``ConvTranspose`` at 4/2/1 on
    an 8x8 input (the lax path) and a 32x32 one (the JAX package's
    kernel-segregated path), with a bias; and the fan-in of the init,
    out_channels * k * k, as torch counts it."""
    x = np.random.default_rng(1).normal(size=(2, hw, hw, 6)).astype(np.float32)
    _check_layer(ConvTranspose_j(5, 4, 2, 1, init_mode="normal02"), ConvTranspose2d(6, 5, 4, 2, 1),
                 [x], train=False)
    layer = ConvTranspose2d(512, 64, 4, 2, 1, generator=torch.Generator().manual_seed(0))
    assert layer.weight.shape == (512, 64, 4, 4)
    assert float(layer.bias.abs().max()) <= 1 / np.sqrt(64 * 16)
    assert abs(float(layer.weight.std()) - 0.02) < 1e-3


def test_affine_instance_norm_matches_jax():
    """Affine IN (dualgan): the kernel's plain version at slope 1, then the
    per-channel weight and bias, as ``InstanceNorm(affine=True)``; torch's
    init (ones, zeros) and names; random affine values for the comparison."""
    x = np.random.default_rng(2).normal(3.0, 2.0, size=(2, 5, 5, 7)).astype(np.float32)
    module_j = InstanceNorm_j(affine=True)
    variables = module_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert [k for k, _ in InstanceNorm(7, affine=True).named_parameters()] == ["weight", "bias"]
    assert torch.equal(InstanceNorm(7, affine=True).weight, torch.ones(7))
    rng = np.random.default_rng(3)
    params = {"scale": rng.normal(1, 0.5, 7).astype(np.float32),
              "bias": rng.normal(0, 0.5, 7).astype(np.float32)}
    cot = rng.normal(size=x.shape).astype(np.float32)
    f = lambda p, x: jnp.sum(module_j.apply({"params": p}, x) * cot)
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    module_t = InstanceNorm(7, affine=True)
    load_jax_params(module_t, params)
    xt = nchw(x).requires_grad_(True)
    y = module_t(xt)
    np.testing.assert_allclose(nhwc(y), np.asarray(module_j.apply({"params": params}, x)),
                               atol=1e-5)
    (y * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(module_t.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4)
    np.testing.assert_allclose(module_t.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-4)
    assert set(variables["params"]) == {"scale", "bias"}


@pytest.mark.parametrize("kind", ["plain", "dropout", "bias", "affine", "no_norm"])
def test_unet_down_matches_jax(kind):
    """UNetDown at narrow widths (8 to 16 channels), each option; IN and
    LeakyReLU(0.2) as one kernel except with the affine."""
    kw = {"plain": {}, "dropout": {"dropout": 0.5}, "bias": {"use_bias": True},
          "affine": {"affine": True, "dropout": 0.5}, "no_norm": {"normalize": False}}[kind]
    port_kw = {k: v for k, v in kw.items() if k != "affine"}
    if kw.get("affine"):
        port_kw["norm"] = "affine"
    x = np.random.default_rng(4).normal(size=(2, 16, 16, 8)).astype(np.float32)
    n, _ = _check_layer(UNetDown_j(16, init_mode="normal02", **kw), UNetDown(8, 16, **port_kw),
                        [x], rngs={"dropout": jax.random.PRNGKey(7)})
    assert n == (1 if kw.get("dropout") else 0)


@pytest.mark.parametrize("kind", ["plain", "dropout", "bias", "affine"])
def test_unet_up_matches_jax(kind):
    """UNetUp at narrow widths: the transposed conv, the norm, ReLU, the
    dropout, and the skip concatenated on the channel axis."""
    kw = {"plain": {}, "dropout": {"dropout": 0.5}, "bias": {"use_bias": True},
          "affine": {"affine": True, "dropout": 0.5}}[kind]
    port_kw = {k: v for k, v in kw.items() if k != "affine"}
    if kw.get("affine"):
        port_kw["norm"] = "affine"
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 4, 12)).astype(np.float32)
    skip = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    n, _ = _check_layer(UNetUp_j(10, init_mode="normal02", **kw), UNetUp(12, 10, **port_kw),
                        [x, skip], rngs={"dropout": jax.random.PRNGKey(8)})
    assert n == (1 if kw.get("dropout") else 0)


@pytest.mark.parametrize("kind", ["cyclegan", "pix2pix", "discogan", "dualgan"])
def test_patchgan_matches_jax(kind):
    """The generalised PatchGAN at narrow filters: four blocks with head
    bias (cyclegan), six input channels and no head bias (pix2pix), three
    blocks (discogan), BatchNorm(eps=0.8) and an unpadded head (dualgan, its
    running statistics after one training forward too)."""
    f4, f3 = (8, 16, 24, 32), (8, 16, 24)
    cfg = {
        "cyclegan": ({"filters": f4}, {"filters": f4}, 3),
        "pix2pix": ({"filters": f4, "head_bias": False, "init_mode": "normal02"},
                    {"filters": f4, "head_bias": False, "init_mode": "normal02"}, 6),
        "discogan": ({"filters": f3, "init_mode": "normal02"},
                     {"filters": f3, "init_mode": "normal02"}, 3),
        "dualgan": ({"filters": f3, "norm": "batch08", "head_padding": 0, "init_mode": "normal02"},
                    {"filters": f3, "norm": "batch08", "head_padding": 0, "init_mode": "normal02"},
                    3),
    }[kind]
    kw_j, kw_t, cin = cfg
    x = np.random.default_rng(6).normal(size=(2, 32, 32, cin)).astype(np.float32)
    module_t = PatchGAN(cin, generator=torch.Generator().manual_seed(0), **kw_t)
    _, stats = _check_layer(PatchGAN_j(**kw_j), module_t, [x], mutable=kind == "dualgan")
    assert bool(stats) == (kind == "dualgan")
    if kind == "dualgan":
        variables = PatchGAN_j(**kw_j).init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        _, mut = jax.jit(lambda v, x: PatchGAN_j(**kw_j).apply(v, x, train=True,
                                                               mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        want = PatchGAN(cin, **kw_t)
        load_jax_params(want, ordered(variables["params"], key_order(variables["params"])),
                        ordered(mut["batch_stats"], key_order(variables["batch_stats"])))
        for k, v in stats.items():
            np.testing.assert_allclose(v.numpy(), want.state_dict()[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_resize_bilinear_shrinks_as_jax():
    """ccgan's 128 -> 32, and 128 -> 64x48: ``jax.image.resize`` widens its
    triangle filter when it shrinks (antialiasing), as
    ``F.interpolate(antialias=True)``; 1e-6 absolute."""
    x = np.random.default_rng(7).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    for hw in ((32, 32), (64, 48)):
        want = np.asarray(resize_bilinear_j(jnp.asarray(x), hw))
        np.testing.assert_allclose(nhwc(resize_bilinear(nchw(x), hw)), want, atol=1e-6,
                                   err_msg=str(hw))
