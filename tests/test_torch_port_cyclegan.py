"""The port's CycleGAN slice against the JAX package, on the CPU at 32px with
one residual block and batch 1.

The JAX reference (``tpugan.models.cyclegan``) is built and jitted once per
module. Its initial parameters go into the port's modules through
``load_jax_params``; both frameworks then take one training step on the same
uint8 batch. The replay buffers make no random draw before 50 pushes, so the
first step needs no shared random stream.

Tolerances, float32 on both sides with sums in different orders:
- forwards: 1e-5 absolute on outputs of unit scale;
- the five losses: 1e-4 relative;
- gradients: 1e-3 relative, plus 1e-4 of the largest gradient of that module
  absolute (the conv biases that feed an instance norm have a true gradient
  of 0, so what both sides hold there is rounding noise);
- parameters after Adam: 1e-5 absolute where the gradient is above that
  noise floor, and 2*lr elsewhere. On Adam's first step the update is
  lr*g/(|g|+eps), which turns the rounding noise of a zero gradient into
  +-lr. That is every conv bias that feeds an instance norm, and some
  weights.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

from tpugan.io.torch_interop import export_state_dict
from tpugan.losses import l1 as l1_j
from tpugan.losses import mse as mse_j
from tpugan.models import cyclegan as cg_j
from tpugan.models._common import apply_mod
from tpugan.train.optim import linear_decay_schedule
from tpugan.train.state import normalize_uint8 as normalize_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import cyclegan as cg_t
from tpugan_torch.nn.im2im import GeneratorResNet, PatchGAN
from tpugan_torch.train.loop import reject_unported_flags
from tpugan_torch.train.optim import linear_decay_lambda
from tpugan_torch.train.replay import ReplayBuffer
from tpugan_torch.train.state import normalize_uint8

H = 32
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(mod):
    return mod.Config(img_height=H, img_width=H, n_residual_blocks=1, batch_size=1,
                      synthetic_data=True)


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (1, H, H, 3), dtype=np.uint8),
            rng.integers(0, 256, (1, H, H, 3), dtype=np.uint8))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_grads(cfg, modules, params, a_u8, b_u8):
    """The gradients the JAX step applies, recomputed with its loss
    functions (tpugan/models/cyclegan.py:142-213). The buffers are empty, so
    the replayed fakes are the fakes."""
    G_AB, G_BA, D_A, D_B = (modules[k] for k in cg_j.MODULES)
    real_a, real_b = normalize_j(a_u8), normalize_j(b_u8)
    n = real_a.shape[0]

    def g_loss_fn(g_tree):
        ab, _ = apply_mod(G_AB, g_tree["G_AB"], None, jnp.concatenate([real_a, real_b]))
        ba, _ = apply_mod(G_BA, g_tree["G_BA"], None, jnp.concatenate([real_b, real_a]))
        fake_b, id_b, fake_a, id_a = ab[:n], ab[n:], ba[:n], ba[n:]
        loss_id = (l1_j(id_a, real_a) + l1_j(id_b, real_b)) / 2
        pred_b, _ = apply_mod(D_B, params["D_B"], None, fake_b)
        pred_a, _ = apply_mod(D_A, params["D_A"], None, fake_a)
        loss_gan = (mse_j(pred_b, 1.0) + mse_j(pred_a, 1.0)) / 2
        recov_a, _ = apply_mod(G_BA, g_tree["G_BA"], None, fake_b)
        recov_b, _ = apply_mod(G_AB, g_tree["G_AB"], None, fake_a)
        loss_cyc = (l1_j(recov_a, real_a) + l1_j(recov_b, real_b)) / 2
        loss = loss_gan + cfg.lambda_cyc * loss_cyc + cfg.lambda_id * loss_id
        return loss, (fake_a, fake_b)

    def d_loss_fn(p, D, real, fake):
        pred, _ = apply_mod(D, p, None, jnp.concatenate([real, fake]))
        return (mse_j(pred[:n], 1.0) + mse_j(pred[n:], 0.0)) / 2

    g_tree = {"G_AB": params["G_AB"], "G_BA": params["G_BA"]}
    (_, (fake_a, fake_b)), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(g_tree)
    return {
        **g_grads,
        "D_A": jax.grad(d_loss_fn)(params["D_A"], D_A, real_a, jax.lax.stop_gradient(fake_a)),
        "D_B": jax.grad(d_loss_fn)(params["D_B"], D_B, real_b, jax.lax.stop_gradient(fake_b)),
    }


@pytest.fixture(scope="module")
def jax_ref():
    cfg = _cfg(cg_j)
    modules = cg_j.build(cfg)
    state = cg_j.create_state(cfg, modules, steps_per_epoch=10)
    a, b = _batch()
    params0 = _np_tree(state.params)
    new_state, out = jax.jit(cg_j.make_step(cfg, modules, steps_per_epoch=10))(state, a, b)
    grads = jax.jit(lambda p, x, y: _jax_grads(cfg, modules, p, x, y))(state.params, a, b)
    return {
        "cfg": cfg, "modules": modules, "a": a, "b": b, "params0": params0,
        "params1": _np_tree(new_state.params), "out": {k: float(v) for k, v in out.items()},
        "grads": _np_tree(grads),
    }


@pytest.fixture(scope="module")
def torch_step(jax_ref):
    cfg = _cfg(cg_t)
    modules = cg_t.build(cfg, CPU)
    for name in cg_t.MODULES:
        load_jax_params(modules[name], jax_ref["params0"][name])
    state = cg_t.create_state(cfg, modules, CPU)
    step = cg_t.make_step(cfg, modules, CPU)
    state, out = step(state, torch.from_numpy(jax_ref["a"]), torch.from_numpy(jax_ref["b"]))
    return {"cfg": cfg, "modules": modules, "state": state,
            "out": {k: float(v) for k, v in out.items()}}


def _fresh(name):
    cfg = _cfg(cg_t)
    if name.startswith("G"):
        return GeneratorResNet(cfg.channels, cfg.n_residual_blocks)
    return PatchGAN(cfg.channels)


def _as_torch(name, tree):
    """A flax tree of the module ``name`` in the port's layout, by key."""
    return {k: v.clone() for k, v in load_jax_params(_fresh(name), tree).state_dict().items()}


def _feeds_instance_norm(module, key):
    """True for the bias of a conv whose output goes into an InstanceNorm."""
    if not key.endswith(".bias"):
        return False
    from tpugan_torch.nn.layers import Conv2d, InstanceNorm

    seq_path, conv_idx = key.rsplit(".", 1)[0].rsplit(".", 1)
    seq = module.get_submodule(seq_path)
    names = list(seq._modules)
    i = names.index(conv_idx)
    return isinstance(seq[i], Conv2d) and i + 1 < len(names) and isinstance(
        seq._modules[names[i + 1]], InstanceNorm
    )


@pytest.mark.parametrize("name", ["G_AB", "D_A"])
def test_load_jax_params_equals_export_state_dict(jax_ref, name):
    module = _fresh(name)
    want = export_state_dict(jax_ref["params0"][name], module.state_dict())
    got = load_jax_params(module, jax_ref["params0"][name]).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["G_AB", "D_A"])
def test_forward_matches_jax(jax_ref, name):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, H, H, 3)).astype(np.float32)
    y_j, _ = apply_mod(jax_ref["modules"][name], jax.device_put(jax_ref["params0"][name]),
                       None, jnp.asarray(x))
    module = load_jax_params(_fresh(name), jax_ref["params0"][name])
    with torch.no_grad():
        y_t = module(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(y_t.numpy().transpose(0, 2, 3, 1), np.asarray(y_j), atol=1e-5)


def test_step_losses_match_jax(jax_ref, torch_step):
    for k, v in jax_ref["out"].items():
        np.testing.assert_allclose(torch_step["out"][k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", cg_t.MODULES)
def test_step_gradients_match_jax(jax_ref, torch_step, name):
    want = _as_torch(name, jax_ref["grads"][name])
    module = torch_step["modules"][name]
    got = {k: p.grad for k, p in module.named_parameters()}
    assert list(got) == list(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-4 * scale, msg=k)


@pytest.mark.parametrize("name", cg_t.MODULES)
def test_step_params_after_adam_match_jax(jax_ref, torch_step, name):
    want = _as_torch(name, jax_ref["params1"][name])
    grads = _as_torch(name, jax_ref["grads"][name])
    noise = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    module = torch_step["modules"][name]
    lr = torch_step["cfg"].lr
    n_in_biases = 0
    for k, p in module.named_parameters():
        diff = (p.detach() - want[k]).abs()
        settled = grads[k].abs() > noise
        assert float(diff.max()) <= 2 * lr, k
        if settled.any():
            assert float(diff[settled].max()) <= 1e-5, k
        n_in_biases += _feeds_instance_norm(module, k)
    assert n_in_biases == (7 if name.startswith("G") else 3)  # 3+2+2 in G; 3 in D


def test_replay_fills_without_draws_then_swaps():
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    buf = ReplayBuffer(4, (1, 2, 2), CPU, gen)
    first = torch.arange(4.0).reshape(4, 1, 1, 1).expand(4, 1, 2, 2)
    assert torch.equal(buf.push_and_pop(first), first)
    assert buf.count == 4 and torch.equal(gen.get_state(), before)
    new = torch.full((3, 1, 2, 2), 9.0)
    out = buf.push_and_pop(new, coins=[0.9, 0.1, 0.7], idxs=[2, 0, 2])
    # swap: old slot 2; keep: the new one; swap again at slot 2: the 9 just stored
    assert out[:, 0, 0, 0].tolist() == [2.0, 9.0, 9.0]
    assert buf.data[:, 0, 0, 0].tolist() == [0.0, 1.0, 9.0, 3.0]


def test_replay_draws_from_generator_once_full():
    buf = ReplayBuffer(2, (1, 1, 1), CPU, torch.Generator().manual_seed(1))
    buf.push_and_pop(torch.zeros(2, 1, 1, 1))
    outs = torch.cat([buf.push_and_pop(torch.full((1, 1, 1, 1), float(i))) for i in range(1, 41)])
    returned_old = (outs.flatten() != torch.arange(1.0, 41.0)).sum().item()
    assert 8 <= returned_old <= 32  # about half of 40 with p = 0.5


def test_lr_lambda_matches_jax_schedule_and_floors_at_zero():
    sched = linear_decay_schedule(1.0, n_epochs=10, decay_start_epoch=4, steps_per_epoch=3,
                                  offset=2)
    factor = linear_decay_lambda(10, 4, offset=2)
    for epoch in range(15):
        assert factor(epoch) == pytest.approx(float(sched(epoch * 3)), abs=1e-7)
    assert factor(14) == 0.0


def test_normalize_uint8_matches_jax():
    a, _ = _batch(3)
    got = normalize_uint8(torch.from_numpy(a)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, np.asarray(normalize_j(jnp.asarray(a))))


@pytest.mark.parametrize("flag", ["--profile_port=1"])
def test_unported_flags_raise(flag):
    """The one flag the port refuses, with its reason: torch has no live
    profiler server. ``--profile_dir``, ``--debug_numerics`` and
    ``--ragged_last_batch`` are ported (``tests/test_torch_port_flags.py``)."""
    from tpugan_torch.utils.config import config_from_args

    cfg = config_from_args(cg_t.Config, [flag])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reject_unported_flags(cfg)
    with pytest.raises(NotImplementedError, match="dynolog"):
        reject_unported_flags(cfg)


def test_dtype_flag_sets_the_compute_dtype():
    """``--dtype bfloat16`` sets the layers' compute dtype as the JAX
    package's flag does (``tests/test_mixed_precision.py::
    test_dtype_flag_resolves``), and ``--dtype float32`` sets it back; both
    pass ``reject_unported_flags``."""
    from tpugan_torch.nn.layers import compute_dtype, resolve_dtype
    from tpugan_torch.utils.config import config_from_args

    assert resolve_dtype("float32") is None
    assert resolve_dtype("bfloat16") is torch.bfloat16
    try:
        for flag, want in (("bfloat16", torch.bfloat16), ("float32", None)):
            cfg = config_from_args(cg_t.Config, ["--dtype", flag])
            reject_unported_flags(cfg)
            assert compute_dtype() is want
    finally:
        config_from_args(cg_t.Config, [])
    assert compute_dtype() is None


def test_run_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cg_t.main(["--synthetic_data", "--output_dir", str(tmp_path)])


def test_cli_lists_cyclegan(capsys):
    from tpugan_torch.__main__ import main

    assert main(["list"]) == 0
    assert "cyclegan" in capsys.readouterr().out


def test_port_runs_a_step_without_importing_jax(tmp_path):
    code = (
        "import sys, numpy as np, torch\n"
        "from tpugan_torch.models import cyclegan as cg\n"
        "cfg = cg.Config(img_height=16, img_width=16, n_residual_blocks=1,"
        " synthetic_data=True, output_dir=sys.argv[1])\n"
        "dev = torch.device('cpu')\n"
        "mods = cg.build(cfg, dev)\n"
        "state = cg.create_state(cfg, mods, dev)\n"
        "loader = cg.make_loader(cfg, dev)\n"
        "state, out = cg.make_step(cfg, mods, dev)(state, *next(loader.epoch(0)))\n"
        "cg.make_sampler(cfg, mods, dev)(state, out, 0)\n"
        "assert all(np.isfinite(float(v)) for v in out.values()), out\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
    assert (tmp_path / "images" / "monet2photo" / "0.png").exists()


def test_checkpoint_then_resume_roundtrip(tmp_path):
    from tpugan_torch.models._im2im_common import checkpoint_epoch, maybe_resume

    cfg = cg_t.Config(img_height=H, img_width=H, n_residual_blocks=1,
                      output_dir=str(tmp_path), checkpoint_interval=1)
    saved = cg_t.build(cfg, CPU)
    checkpoint_epoch(saved, cfg, 3, cg_t.MODULES)
    ckpt_dir = tmp_path / "saved_models" / cfg.dataset_name
    assert sorted(p.name for p in ckpt_dir.iterdir()) == sorted(
        f"{m}_3.pth" for m in cg_t.MODULES
    )
    resumed = cg_t.build(cg_t.Config(img_height=H, img_width=H, n_residual_blocks=1, seed=1), CPU)
    maybe_resume(resumed, dataclasses.replace(cfg, epoch=3), cg_t.MODULES)
    for name in cg_t.MODULES:
        for (k, a), b in zip(saved[name].state_dict().items(), resumed[name].state_dict().values()):
            assert torch.equal(a, b), (name, k)


def test_layer_options_not_ported_raise():
    """A layer option that no trainer uses raises, naming the ROADMAP section
    that leaves it out (a transposed conv's ``he`` init; Conv2d's is the VGG
    features'). Affine IN (dualgan) and tracked IN (stargan) are ported, and
    each needs its channel count."""
    from tpugan_torch.nn.layers import ConvTranspose2d, InstanceNorm

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ConvTranspose2d(4, 4, 3, init_mode="he")
    with pytest.raises(ValueError, match="num_features"):
        InstanceNorm(track_running_stats=True)
    with pytest.raises(ValueError, match="num_features"):
        InstanceNorm(affine=True)
    assert [k for k, _ in InstanceNorm(4, affine=True).named_parameters()] == ["weight", "bias"]
