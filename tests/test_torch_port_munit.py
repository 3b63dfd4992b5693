"""The port's MUNIT slice against the JAX package, on the CPU at 64px with
``dim 8``, one residual block and batch 1.

The JAX reference (``tpugan.models.munit``) is built once per module, and one
jitted function gives both its training step and the gradients that step
applies (recomputed with its loss functions). Its initial parameters go into
the port's modules through ``load_jax_params``; both frameworks then take one
step on the same uint8 batch, the port with JAX's style draws passed in. At
64px the third MultiDiscriminator tower normalises 1x1 maps.

Tolerances, float32 on both sides with sums in different orders:
- forwards: 1e-5 absolute on outputs of unit scale;
- the two losses: 1e-4 relative;
- gradients: 1e-3 relative, plus 1e-4 of the largest gradient of that module
  absolute (a conv bias that feeds an instance norm or an AdaIN has a true
  gradient of 0, so what both sides hold there is rounding noise);
- parameters after Adam: 1e-5 absolute where the gradient is above that
  noise floor, and 2*lr elsewhere (Adam's first step is lr*g/(|g|+eps),
  which turns the noise of a zero gradient into +-lr).
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

from tpugan.data.im2im import joint_hflip_transform as jhf_j
from tpugan.data.im2im import paired_or_synthetic as pos_j
from tpugan.io.torch_interop import export_state_dict
from tpugan.losses import l1 as l1_j
from tpugan.models import munit as mu_j
from tpugan.models._common import apply_mod
from tpugan.nn.style import multi_d_loss as multi_d_loss_j
from tpugan.train.state import normalize_uint8 as normalize_j
from tpugan_torch.data.im2im import joint_hflip_transform, paired_or_synthetic
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import munit as mu_t
from tpugan_torch.nn.style import MultiDiscriminator, MunitDecoder

H = 64
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_height=H, img_width=H, dim=8, n_residual=1, batch_size=1, synthetic_data=True)


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (1, H, H, 3), dtype=np.uint8),
            rng.integers(0, 256, (1, H, H, 3), dtype=np.uint8))


def _np_tree(tree, like):
    """numpy leaves of ``tree`` in the dict order of ``like``: flax keeps
    params in insertion order, which is call order and what
    ``load_jax_params`` pairs by, but jax's tree functions and ``jit``
    return dicts sorted by key (``Conv_10`` before ``Conv_2``)."""
    if isinstance(like, dict):
        return {k: _np_tree(tree[k], v) for k, v in like.items()}
    return np.asarray(tree)


def _styles(state, cfg, n):
    """The JAX step's draws (tpugan/models/munit.py:170-172)."""
    _, k_s1, k_s2 = jax.random.split(state.rng, 3)
    return (jax.random.normal(k_s1, (n, cfg.style_dim)),
            jax.random.normal(k_s2, (n, cfg.style_dim)))


def _jax_grads(cfg, modules, params, a_u8, b_u8, style_1, style_2):
    """The gradients the JAX step applies, from its loss functions
    (tpugan/models/munit.py:175-226)."""
    Enc1, Dec1, Enc2, Dec2, D1, D2 = (modules[k] for k in mu_j.MODULES)
    x1, x2 = normalize_j(a_u8), normalize_j(b_u8)

    def g_loss_fn(g_tree):
        (c1, s1), _ = apply_mod(Enc1, g_tree["Enc1"], None, x1)
        (c2, s2), _ = apply_mod(Enc2, g_tree["Enc2"], None, x2)
        x11, _ = apply_mod(Dec1, g_tree["Dec1"], None, c1, s1)
        x22, _ = apply_mod(Dec2, g_tree["Dec2"], None, c2, s2)
        x21, _ = apply_mod(Dec1, g_tree["Dec1"], None, c2, style_1)
        x12, _ = apply_mod(Dec2, g_tree["Dec2"], None, c1, style_2)
        (c21, s21), _ = apply_mod(Enc1, g_tree["Enc1"], None, x21)
        (c12, s12), _ = apply_mod(Enc2, g_tree["Enc2"], None, x12)
        d1_outs, _ = apply_mod(D1, params["D1"], None, x21)
        d2_outs, _ = apply_mod(D2, params["D2"], None, x12)
        loss = (
            multi_d_loss_j(d1_outs, 1.0) + multi_d_loss_j(d2_outs, 1.0)
            + 10.0 * l1_j(x11, x1) + 10.0 * l1_j(x22, x2)
            + l1_j(s21, style_1) + l1_j(s12, style_2)
            + l1_j(c12, jax.lax.stop_gradient(c1)) + l1_j(c21, jax.lax.stop_gradient(c2))
        )
        return loss, (x21, x12)

    def d_loss_fn(p, D, real, fake):
        real_outs, _ = apply_mod(D, p, None, real)
        fake_outs, _ = apply_mod(D, p, None, fake)
        return multi_d_loss_j(real_outs, 1.0) + multi_d_loss_j(fake_outs, 0.0)

    g_tree = {k: params[k] for k in mu_j.MODULES[:4]}
    (_, (x21, x12)), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(g_tree)
    return {
        **g_grads,
        "D1": jax.grad(d_loss_fn)(params["D1"], D1, x1, jax.lax.stop_gradient(x21)),
        "D2": jax.grad(d_loss_fn)(params["D2"], D2, x2, jax.lax.stop_gradient(x12)),
    }


@pytest.fixture(scope="module")
def jax_ref():
    cfg = mu_j.Config(**SMALL)
    modules = mu_j.build(cfg)
    state = mu_j.create_state(cfg, modules, steps_per_epoch=10)
    a, b = _batch()
    params0 = _np_tree(state.params, state.params)
    step = mu_j.make_step(cfg, modules, steps_per_epoch=10)

    def step_and_grads(s, x, y):
        new_state, out = step(s, x, y)
        grads = _jax_grads(cfg, modules, s.params, x, y, *_styles(s, cfg, 1))
        return new_state, out, grads

    new_state, out, grads = jax.jit(step_and_grads)(state, a, b)
    return {
        "cfg": cfg, "modules": modules, "a": a, "b": b, "params0": params0,
        "styles": [np.asarray(s) for s in _styles(state, cfg, 1)],
        "params1": _np_tree(new_state.params, params0),
        "out": {k: float(v) for k, v in out.items()}, "grads": _np_tree(grads, params0),
    }


@pytest.fixture(scope="module")
def torch_step(jax_ref):
    cfg = mu_t.Config(**SMALL)
    modules = mu_t.build(cfg, CPU)
    for name in mu_t.MODULES:
        load_jax_params(modules[name], jax_ref["params0"][name])
    state = mu_t.create_state(cfg, modules, CPU)
    step = mu_t.make_step(cfg, modules, CPU)
    styles = [torch.tensor(s) for s in jax_ref["styles"]]
    state, out = step(state, torch.from_numpy(jax_ref["a"]), torch.from_numpy(jax_ref["b"]),
                      styles=styles)
    return {"cfg": cfg, "modules": modules, "out": {k: float(v) for k, v in out.items()}}


def _fresh(name, cfg=None):
    cfg = cfg or mu_t.Config(**SMALL)
    if name.startswith("Enc"):
        return mu_t.MunitEncoder(cfg.channels, cfg.dim, cfg.n_residual, cfg.n_downsample,
                                 cfg.style_dim)
    if name.startswith("Dec"):
        return MunitDecoder(cfg.channels, cfg.dim, cfg.n_residual, cfg.n_downsample,
                            cfg.style_dim)
    return MultiDiscriminator(cfg.channels)


def _as_torch(name, tree):
    """A flax tree of the module ``name`` in the port's layout, by key."""
    return {k: v.clone() for k, v in load_jax_params(_fresh(name), tree).state_dict().items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name", ["Enc1", "Dec1", "D1"])
def test_load_jax_params_equals_export_state_dict(jax_ref, name):
    module = _fresh(name)
    want = export_state_dict(jax_ref["params0"][name], module.state_dict())
    got = load_jax_params(module, jax_ref["params0"][name]).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if name == "Dec1":
        assert {k.rsplit(".", 1)[1] for k in got} == {"weight", "bias", "gamma", "beta"}


def test_encoder_forward_matches_jax(jax_ref):
    x = np.random.default_rng(4).uniform(-1, 1, (2, H, H, 3)).astype(np.float32)
    (c_j, s_j), _ = apply_mod(jax_ref["modules"]["Enc1"], jax_ref["params0"]["Enc1"], None,
                              jnp.asarray(x))
    module = load_jax_params(_fresh("Enc1"), jax_ref["params0"]["Enc1"])
    with torch.no_grad():
        c_t, s_t = module(_nchw(x))
    np.testing.assert_allclose(_nhwc(c_t), np.asarray(c_j), atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


def test_decoder_forward_matches_jax(jax_ref):
    rng = np.random.default_rng(5)
    cfg = jax_ref["cfg"]
    content = rng.normal(0, 1, (2, H // 4, H // 4, 4 * cfg.dim)).astype(np.float32)
    style = rng.normal(0, 1, (2, cfg.style_dim)).astype(np.float32)
    y_j, _ = apply_mod(jax_ref["modules"]["Dec1"], jax_ref["params0"]["Dec1"], None,
                       jnp.asarray(content), jnp.asarray(style))
    module = load_jax_params(_fresh("Dec1"), jax_ref["params0"]["Dec1"])
    with torch.no_grad():
        y_t = module(_nchw(content), torch.from_numpy(style))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)


def test_multi_discriminator_forward_matches_jax(jax_ref):
    x = np.random.default_rng(6).uniform(-1, 1, (2, H, H, 3)).astype(np.float32)
    outs_j, _ = apply_mod(jax_ref["modules"]["D1"], jax_ref["params0"]["D1"], None,
                          jnp.asarray(x))
    module = load_jax_params(_fresh("D1"), jax_ref["params0"]["D1"])
    with torch.no_grad():
        outs_t = module(_nchw(x))
    assert [o.shape[-1] for o in outs_t] == [4, 2, 1]  # the third tower's last IN is 1x1
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(_nhwc(o_t), np.asarray(o_j), atol=1e-5)


@pytest.mark.parametrize("name,count", [("Enc1", 4_872_968), ("Dec1", 5_432_067),
                                        ("D1", 8_283_459)])
def test_param_counts_at_default_widths_equal_jax(name, count):
    """tests/test_style_family.py:41-45 pins the JAX modules to these."""
    module = _fresh(name, mu_t.Config())
    assert sum(p.numel() for p in module.parameters()) == count


def test_step_losses_match_jax(jax_ref, torch_step):
    assert set(torch_step["out"]) == set(jax_ref["out"]) == {"d_loss", "g_loss"}
    for k, v in jax_ref["out"].items():
        np.testing.assert_allclose(torch_step["out"][k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", mu_t.MODULES)
def test_step_gradients_match_jax(jax_ref, torch_step, name):
    want = _as_torch(name, jax_ref["grads"][name])
    module = torch_step["modules"][name]
    got = {k: p.grad for k, p in module.named_parameters()}
    assert list(got) == list(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-4 * scale, msg=k)


@pytest.mark.parametrize("name", mu_t.MODULES)
def test_step_params_after_adam_match_jax(jax_ref, torch_step, name):
    want = _as_torch(name, jax_ref["params1"][name])
    grads = _as_torch(name, jax_ref["grads"][name])
    noise = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    module = torch_step["modules"][name]
    lr = torch_step["cfg"].lr
    for k, p in module.named_parameters():
        diff = (p.detach() - want[k]).abs()
        settled = grads[k].abs() > noise
        assert float(diff.max()) <= 2 * lr, k
        if settled.any():
            assert float(diff[settled].max()) <= 1e-5, k


def test_step_draws_styles_from_the_state_generator():
    cfg = mu_t.Config(**SMALL)
    modules = mu_t.build(cfg, CPU)
    state = mu_t.create_state(cfg, modules, CPU)
    want = torch.Generator().manual_seed(cfg.seed)
    want_1, want_2 = (torch.randn((1, cfg.style_dim), generator=want) for _ in range(2))
    seen = []
    dec2_forward = modules["Dec2"].forward
    modules["Dec2"].forward = lambda c, s: seen.append(s.clone()) or dec2_forward(c, s)
    mu_t.make_step(cfg, modules, CPU)(state, *(torch.from_numpy(a) for a in _batch()))
    assert torch.equal(seen[1], want_2)  # Dec2(c1, style_2) is its second call
    assert torch.equal(state.generator.get_state(), want.get_state())
    assert not torch.equal(want_1, want_2)


def test_sampling_leaves_the_training_draws_alone(tmp_path):
    """The sampler draws its style codes from a generator of its own, seeded
    from (seed, batches_done), as the JAX sampler folds batches_done into a
    key it does not keep (``tpugan/models/munit.py:295``): a sample leaves
    ``state.generator`` as it was, the next step's style draws equal those
    of a run that did not sample, and the same batches_done gives the same
    sheet."""
    cfg = mu_t.Config(**SMALL, output_dir=str(tmp_path))
    modules = mu_t.build(cfg, CPU)
    sampled, plain = (mu_t.create_state(cfg, modules, CPU) for _ in range(2))
    before = sampled.generator.get_state()
    sample = mu_t.make_sampler(cfg, modules, CPU)
    sheet = tmp_path / "images" / "edges2shoes" / "0.png"
    sample(sampled, {}, 0)
    first = sheet.read_bytes()
    assert torch.equal(sampled.generator.get_state(), before)
    sample(sampled, {}, 0)
    assert sheet.read_bytes() == first
    seen = []
    dec2_forward = modules["Dec2"].forward
    modules["Dec2"].forward = lambda c, s: seen.append(s.clone()) or dec2_forward(c, s)
    step = mu_t.make_step(cfg, modules, CPU)
    batch = [torch.from_numpy(a) for a in _batch()]
    for state in (sampled, plain):
        step(state, *batch)
    assert torch.equal(seen[1], seen[3])  # Dec2(c1, style_2) of each step
    assert torch.equal(sampled.generator.get_state(), plain.generator.get_state())


def test_sampler_seeds_do_not_collide_across_seeds(tmp_path):
    """Seed s at batches_done 1000003 + b and seed s + 1 at b draw different
    style codes, as JAX's fold_in of batches_done into each seed's key does."""
    seen = []
    for seed, batches_done in ((0, 1000003), (1, 0)):
        cfg = mu_t.Config(**SMALL, output_dir=str(tmp_path), seed=seed)
        modules = mu_t.build(cfg, CPU)
        dec2_forward = modules["Dec2"].forward
        modules["Dec2"].forward = lambda c, s: seen.append(s.clone()) or dec2_forward(c, s)
        mu_t.make_sampler(cfg, modules, CPU)(mu_t.create_state(cfg, modules, CPU), {},
                                             batches_done)
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])


@pytest.mark.parametrize("split", ["train", "val"])
def test_paired_or_synthetic_identical(tmp_path, split):
    got = paired_or_synthetic(str(tmp_path), "none", 16, 16, split=split, synthetic_n=6, seed=3)
    want = pos_j(str(tmp_path), "none", 16, 16, split=split, synthetic_n=6, seed=3)
    assert got[2] is want[2] is False
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_joint_hflip_transform_identical():
    a, b, _ = paired_or_synthetic("", "none", 12, 10, synthetic=True, synthetic_n=8)
    for epoch, bidx in ((0, 0), (1, 3), (2, 5)):
        got = joint_hflip_transform(7)((a, b), epoch, bidx)
        want = jhf_j(7)((a, b), epoch, bidx)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_loader_batches_identical():
    cfg_t, cfg_j = mu_t.Config(**SMALL), mu_j.Config(**SMALL)
    t_loader, j_loader = mu_t.make_loader(cfg_t, CPU), mu_j.make_loader(cfg_j)
    assert len(t_loader) == len(j_loader) == 512
    for got, want in zip(t_loader.epoch(1), j_loader.epoch(1)):
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
        break


def test_config_flags_match_jax():
    got = {f.name: (f.default, f.type) for f in dataclasses.fields(mu_t.Config)}
    want = {f.name: (f.default, f.type) for f in dataclasses.fields(mu_j.Config)}
    assert got == want


def test_cli_lists_munit(capsys):
    from tpugan_torch.__main__ import main

    assert main(["list"]) == 0
    assert "munit" in capsys.readouterr().out.split()


def test_run_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mu_t.main(["--synthetic_data", "--output_dir", str(tmp_path)])


def test_checkpoints_then_epoch_resume(tmp_path):
    small = ["--img_height", "64", "--img_width", "64", "--dim", "4", "--n_residual", "1",
             "--synthetic_data", "--max_batches", "1", "--sample_interval", "1",
             "--checkpoint_interval", "1", "--output_dir", str(tmp_path)]
    mu_t.main(small + ["--n_epochs", "2"], CPU)
    ckpt_dir = tmp_path / "saved_models" / "edges2shoes"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == sorted(
        f"{m}_{e}.pth" for m in mu_t.MODULES for e in (0, 1))
    assert sorted(p.name for p in (tmp_path / "images" / "edges2shoes").iterdir()) == [
        "0.png", "1.png"]
    state = mu_t.main(small + ["--n_epochs", "2", "--epoch", "1", "--max_batches", "0"], CPU)
    for name in mu_t.MODULES:
        saved = torch.load(ckpt_dir / f"{name}_1.pth", weights_only=True)
        for k, v in state.modules[name].state_dict().items():
            assert torch.equal(v, saved[k]), (name, k)


def test_port_runs_a_step_without_importing_jax(tmp_path):
    code = (
        "import sys, numpy as np, torch\n"
        "from tpugan_torch.models import munit as mu\n"
        "cfg = mu.Config(img_height=64, img_width=64, dim=4, n_residual=1,"
        " synthetic_data=True, output_dir=sys.argv[1])\n"
        "dev = torch.device('cpu')\n"
        "mods = mu.build(cfg, dev)\n"
        "state = mu.create_state(cfg, mods, dev)\n"
        "loader = mu.make_loader(cfg, dev)\n"
        "state, out = mu.make_step(cfg, mods, dev)(state, *next(loader.epoch(0)))\n"
        "mu.make_sampler(cfg, mods, dev)(state, out, 0)\n"
        "assert all(np.isfinite(float(v)) for v in out.values()), out\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
    sheet = (tmp_path / "images" / "edges2shoes" / "0.png").read_bytes()
    assert sheet[:8] == b"\x89PNG\r\n\x1a\n"
    # 5 rows of a validation image and its 8 translations, padding 2 around
    # the one sheet: (9 * 64 + 4) wide, (5 * 64 + 4) high.
    assert int.from_bytes(sheet[16:20], "big") == 9 * 64 + 4
    assert int.from_bytes(sheet[20:24], "big") == 5 * 64 + 4
