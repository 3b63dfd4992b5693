"""The port's closed-form WGAN-GP (``tpugan_torch.ops.mlp_gp``) and generic
penalty (``tpugan_torch.ops.penalty``) against the JAX package, on the CPU.

On CPU tensors the wrappers run the plain version, so this holds the plain
closed form against ``mlp_gp_xla`` and against ``mlp_gp_pallas`` in interpret
mode, value and weight gradients. The same numpy-seeded inputs go to both
sides; the weights travel as flax (in, out) kernels and enter the port
transposed to nn.Linear's (out, in).

Tolerances, fp32 on both sides with sums in different orders (JAX at
``highest`` matmul precision, tests/conftest.py): 1e-5 relative on the
penalty, 1e-4 relative and 1e-6 absolute on the gradients, as
tests/test_pallas_critic.py:70-78 holds the JAX variants to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.models import wgan_gp as wgan_gp_j
from tpugan.models._common import apply_mod
from tpugan.ops.pallas_critic import mlp_gp_pallas, mlp_gp_xla
from tpugan.ops.penalty import wgan_gp_penalty as wgan_gp_penalty_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.nn.blocks import MLPDiscriminator, MLPGenerator
from tpugan_torch.nn.layers import Linear
from tpugan_torch.ops import mlp_gp as gp
from tpugan_torch.ops.penalty import wgan_gp_penalty
from tpugan_torch.utils import tracing

VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _inputs(b, n0, n1, n2, seed=0):
    """x and flax-layout weights at torch's default init scale."""
    rng = np.random.default_rng(seed)
    u = lambda shape, fan_in: (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)
    x = rng.normal(0, 0.7, (b, n0)).astype(np.float32)
    return x, u((n0, n1), n0), u((n1,), n0), u((n1, n2), n1), u((n2,), n1), u((n2, 1), n2)


def _to_port(x, w1, b1, w2, b2, w3):
    """Torch tensors in the port's layout: nn.Linear's (out, in) weights."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(x), t(w1.T), t(b1), t(w2.T), t(b2), t(w3.T)


def _port_closed_form(*inputs):
    """P and (dw1, dw2, dw3) of the port, gradients back in flax layout."""
    x, w1, b1, w2, b2, w3 = _to_port(*inputs)
    for w in (w1, w2, w3):
        w.requires_grad_()
    p = gp.mlp_grad_penalty(x, w1, b1, w2, b2, w3)
    p.backward()
    return float(p.detach()), (w1.grad.numpy().T, w2.grad.numpy().T, w3.grad.numpy().T)


@pytest.mark.parametrize("shape", [(8, 784, 512, 256), (5, 13, 100, 36)])
@pytest.mark.parametrize("variant", ["xla", "pallas"])
def test_closed_form_matches_jax(variant, shape):
    x, w1, b1, w2, b2, w3 = _inputs(*shape)
    fn = mlp_gp_xla if variant == "xla" else (lambda *a: mlp_gp_pallas(*a, True))
    val_j, (dw1_j, dw2_j, dw3_j) = jax.value_and_grad(
        lambda a, b, c: fn(jnp.asarray(x), a, jnp.asarray(b1), b, jnp.asarray(b2), c),
        argnums=(0, 1, 2),
    )(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3))
    val_t, grads_t = _port_closed_form(x, w1, b1, w2, b2, w3)
    np.testing.assert_allclose(val_t, float(val_j), rtol=VALUE_RTOL)
    for name, got, want in zip(("dw1", "dw2", "dw3"), grads_t, (dw1_j, dw2_j, dw3_j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{variant} {shape} {name}")


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    x, w1, b1, w2, b2, w3 = _to_port(*_inputs(4, 20, 16, 8))
    before = (tracing.counts["gp.fwd"], tracing.counts["gp.bwd"])
    got = gp.mlp_gp_fwd(x, w1, b1, w2, b2, w3)
    want = gp.mlp_gp_fwd_ref(x, w1, b1, w2, b2, w3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    q = gp.q_from(got[0], gp.norm_penalty(got[0])[1], 1.0)
    res = (q, got[1], got[2], w1, w2, got[3], got[4])
    for a, b in zip(gp.mlp_gp_bwd(*res), gp.mlp_gp_bwd_ref(*res)):
        assert torch.equal(a, b)
    assert (tracing.counts["gp.fwd"], tracing.counts["gp.bwd"]) == before


@pytest.fixture(scope="module")
def critic():
    """The JAX critic's initial parameters, interpolation inputs and the
    alpha JAX's ``wgan_gp_penalty`` draws from the key, for both sides."""
    cfg = wgan_gp_j.Config(batch_size=8, latent_dim=16)
    mods = wgan_gp_j.build(cfg)
    d_params = wgan_gp_j.create_state(cfg, mods).params["discriminator"]
    rng = np.random.default_rng(0)
    real = rng.normal(0, 0.7, (8, 28, 28, 1)).astype(np.float32)
    fake = rng.normal(0, 0.7, (8, 28, 28, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(key, (8, 1, 1, 1), jnp.float32))

    def generic(p):
        d_apply = lambda x: apply_mod(mods["discriminator"], p, None, x, train=True)[0]
        return wgan_gp_penalty_j(d_apply, jnp.asarray(real), jnp.asarray(fake), key)

    val, grads = jax.value_and_grad(generic)(d_params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"params": np_tree(d_params), "real": real, "fake": fake, "alpha": alpha,
            "value": float(val), "grads": np_tree(grads)}


def _port_critic(params):
    return load_jax_params(MLPDiscriminator(784, sigmoid=False), params)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _penalty(critic, D, path):
    real, fake = _nchw(critic["real"]), _nchw(critic["fake"])
    alpha = torch.from_numpy(critic["alpha"])
    if path == "generic":
        return wgan_gp_penalty(D, real, fake, alpha=alpha)
    x = (alpha * real + (1.0 - alpha) * fake).reshape(8, -1)
    return gp.mlp_grad_penalty(x, *gp.extract_mlp_critic(D))


@pytest.mark.parametrize("path", ["generic", "closed"])
def test_penalty_matches_jax_generic_penalty(critic, path):
    D = _port_critic(critic["params"])
    p = _penalty(critic, D, path)
    p.backward()
    np.testing.assert_allclose(float(p.detach()), critic["value"], rtol=VALUE_RTOL)
    want = _port_critic(critic["grads"]).state_dict()
    for k, param in D.named_parameters():
        got = torch.zeros_like(param) if param.grad is None else param.grad
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{path} {k}")


def test_generic_and_closed_form_agree_in_the_port(critic):
    out = {}
    for path in ("generic", "closed"):
        D = _port_critic(critic["params"])
        p = _penalty(critic, D, path)
        p.backward()
        out[path] = (float(p.detach()), {k: v.grad for k, v in D.named_parameters()})
    np.testing.assert_allclose(out["closed"][0], out["generic"][0], rtol=VALUE_RTOL)
    for k, g in out["generic"][1].items():
        if k.endswith("weight"):
            torch.testing.assert_close(out["closed"][1][k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("path", ["generic", "closed"])
def test_bias_gradients_are_exactly_zero(critic, path):
    """The penalty does not depend on any bias: the masks' derivative is 0
    almost everywhere, which is what autograd computes too."""
    D = _port_critic(critic["params"])
    _penalty(critic, D, path).backward()
    for i in (0, 2, 4):
        grad = D.model[i].bias.grad
        assert grad is None or float(grad.abs().max()) == 0.0, (path, i)


def test_dead_zone_is_finite():
    """||g|| = 0 gives P = 1, a q coefficient of 0 and finite (zero)
    gradients, as tests/test_pallas_critic.py:111-125."""
    b, n0, n1, n2 = 8, 16, 128, 128
    w1 = torch.zeros(n1, n0, requires_grad=True)
    w2 = torch.zeros(n2, n1, requires_grad=True)
    w3 = torch.zeros(1, n2, requires_grad=True)
    p = gp.mlp_grad_penalty(torch.zeros(b, n0), w1, torch.zeros(n1), w2, torch.zeros(n2), w3)
    p.backward()
    assert float(p) == 1.0
    for w in (w1, w2, w3):
        assert torch.isfinite(w.grad).all() and float(w.grad.abs().max()) == 0.0
    g = torch.zeros(b, n0)
    assert torch.equal(gp.q_from(g, gp.norm_penalty(g)[1], 1.0), g)


def test_extract_mlp_critic_takes_only_the_template_a_critic():
    D = MLPDiscriminator(784, sigmoid=False)
    leaves = gp.extract_mlp_critic(D)
    assert leaves is not None and [t.shape for t in leaves] == [
        (512, 784), (512,), (256, 512), (256,), (1, 256)]
    assert gp.extract_mlp_critic(MLPGenerator((1, 28, 28), 16)) is None
    assert gp.extract_mlp_critic(MLPDiscriminator(784, sigmoid=True)) is None
    extra = MLPDiscriminator(784, sigmoid=False)
    extra.model.append(Linear(1, 1))
    assert gp.extract_mlp_critic(extra) is None
    assert gp.extract_mlp_critic(MLPDiscriminator(784, sigmoid=False).double()) is None
