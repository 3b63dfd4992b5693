"""The port's fused multi-step dispatch on the CPU, and its wgan trainer,
against the unfused loops and the JAX package (mirrors
tests/test_scan_dispatch.py and tests/test_critic_family.py:121-230). The
fused loops run every trainer that fuses: dcgan, lsgan, gan, dragan, cgan,
acgan, sgan and infogan through ``run_training``; wgan, wgan_gp and wgan_div
through ``run_critic_family``.

On a CPU state ``graph_steps`` runs its K steps in a Python loop, so the
fused loops do exactly the arithmetic of the unfused ones: parameters,
metric rows and sample images are compared bit for bit. Against the JAX
package's fused loops only the rows' steps and keys and the PNG names are
compared: the two frameworks draw different numbers.

wgan's steps against the JAX package's, on the same weights, batch and z,
fp32 with sums in different orders: losses 1e-5 relative; images 1e-5
absolute; parameters after RMSprop and the clip 1e-3 relative and 5e-5
absolute (RMSprop's first step is lr * g / (0.1 |g| + eps), about 10 lr
sign(g), so it is compared only where |g| is above 1e-6 of the module's
largest gradient; everywhere the update stays within 10 lr of the clipped
start).
Sizes: DCGAN at 16px, batch 8, latent 16; the critic family at batch 6,
latent 16, n_critic 2.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)

from tpugan.models import dcgan as dc_j
from tpugan.models import wgan as wg_j
from tpugan.models import wgan_div as wd_j
from tpugan.models import wgan_gp as wgp_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import _critic_family as cf_t
from tpugan_torch.models import acgan as ac_t
from tpugan_torch.models import cgan as cg_t
from tpugan_torch.models import dcgan as dc_t
from tpugan_torch.models import dragan as dr_t
from tpugan_torch.models import gan as gan_t
from tpugan_torch.models import infogan as ig_t
from tpugan_torch.models import lsgan as ls_t
from tpugan_torch.models import sgan as sg_t
from tpugan_torch.models import wgan as wg_t
from tpugan_torch.models import wgan_div as wd_t
from tpugan_torch.models import wgan_gp as wgp_t
from tpugan_torch.nn.blocks import MLPDiscriminator, MLPGenerator
from tpugan_torch.train import loop
from tpugan_torch.train.loop import StepObserver, graph_steps

CPU = torch.device("cpu")
B, LATENT, N_CRITIC = 6, 16, 2
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-5
CRITIC = {"wgan": (wg_t, wg_j), "wgan_gp": (wgp_t, wgp_j), "wgan_div": (wd_t, wd_j)}
# The run_training trainers by where their samples come from: the step's
# images (``grid_sampler``), G on its own noise after the step (the class
# grids; infogan's three folders), or the last logged images at each epoch's
# end (dragan).
RUN_TRAINING = {"dcgan": (dc_t, "out"), "lsgan": (ls_t, "out"), "gan": (gan_t, "out"),
                "sgan": (sg_t, "out"), "cgan": (cg_t, "state"), "acgan": (ac_t, "state"),
                "infogan": (ig_t, "state"), "dragan": (dr_t, "epoch")}


def _u8(shape, seed=7):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _dcgan(**kw):
    cfg = dc_t.Config(img_size=16, batch_size=8, latent_dim=LATENT, synthetic_data=True, **kw)
    state = dc_t.create_state(cfg, dc_t.build(cfg, CPU), CPU)
    return cfg, state, dc_t.make_step(cfg, state)


def _critic(mod, **kw):
    cfg = mod.Config(batch_size=B, latent_dim=LATENT, n_critic=N_CRITIC, synthetic_data=True, **kw)
    state = mod.create_state(cfg, mod.build(cfg, CPU), CPU)
    return cfg, state, mod.make_steps(cfg, state)


def _params(state):
    return {f"{r}.{k}": v.detach().clone() for r, m in state.modules.items()
            for k, v in m.state_dict().items()}


def _assert_same_params(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- graph_steps and make_schedule_unit -------------------------------------


def test_graph_steps_on_the_cpu_equals_k_sequential_steps():
    k = 3
    batches = _u8((k, 8, 16, 16, 1))
    _, s1, step1 = _dcgan()
    seq = []
    for j in range(k):
        s1, out = step1(s1, batches[j])
        seq.append(out)
    _, s2, step2 = _dcgan()
    fused = graph_steps(step2, k)
    s2, out = fused(s2, batches)
    assert fused.heavy_keys == ["gen_imgs"] and (fused.calls, fused.replays) == (1, 0)
    assert fused.graph is None  # the CPU never captures
    for n in ("d_loss", "g_loss"):
        assert out[n].shape == (k,)
        assert torch.equal(out[n], torch.stack([o[n] for o in seq]))
    assert torch.equal(out["gen_imgs"], seq[-1]["gen_imgs"])
    assert s1.step == s2.step == k
    _assert_same_params(_params(s1), _params(s2))
    assert torch.equal(s1.draws.get_state(), s2.draws.get_state())


def test_graph_steps_refuses_a_wrong_leading_axis():
    _, state, step = _dcgan()
    with pytest.raises(ValueError, match="expected 3 steps"):
        graph_steps(step, 3)(state, _u8((2, 8, 16, 16, 1)))
    with pytest.raises(ValueError, match="at least 1"):
        graph_steps(step, 0)


def test_host_rows_read_the_stacked_scalars_once_a_dispatch():
    out = {"d_loss": torch.tensor([1.0, 2.0]), "g_loss": torch.tensor([3.0, 4.0]),
           "gen_imgs": torch.zeros(2, 1, 4, 4)}
    rows = loop.host_rows(out, ["gen_imgs"], 2)
    assert [(float(r["d_loss"]), float(r["g_loss"])) for r in rows] == [(1.0, 3.0), (2.0, 4.0)]
    assert all(r["gen_imgs"] is out["gen_imgs"] for r in rows)


@pytest.mark.parametrize("name", sorted(CRITIC))
def test_make_schedule_unit_equals_the_d_g_d_sequence(name):
    """The unit (d_step on imgs[0], g_step on its z, d_steps on the rest)
    against the port's own sequence, and under graph_steps with K = 2."""
    mod = CRITIC[name][0]
    imgs = _u8((2, N_CRITIC, B, 28, 28, 1))
    cfg, s1, (d1, g1) = _critic(mod)
    seq = []
    for u in imgs:
        s1, d0 = d1(s1, u[0])
        s1, g_out = g1(s1, d0["z"])
        row = {"d_loss": d0["d_loss"], "g_loss": g_out["g_loss"]}
        for j in range(1, N_CRITIC):
            s1, dj = d1(s1, u[j])
            row["_d_loss%d" % j] = dj["d_loss"]
        seq.append((row, g_out["gen_imgs"]))
    cfg, s2, (d2, g2) = _critic(mod)
    fused = graph_steps(cf_t.make_schedule_unit(cfg, d2, g2), 2)
    s2, out = fused(s2, imgs)
    assert sorted(out) == ["_d_loss1", "d_loss", "g_loss", "gen_imgs"]
    for n in ("d_loss", "g_loss", "_d_loss1"):
        assert torch.equal(out[n], torch.stack([r[n] for r, _ in seq])), n
    assert torch.equal(out["gen_imgs"], seq[-1][1])
    assert s1.step == s2.step == 2 * N_CRITIC
    _assert_same_params(_params(s1), _params(s2))
    assert torch.equal(s1.draws.get_state(), s2.draws.get_state())


# --- The fused loops against the unfused ones --------------------------------


def _run_main(main, argv, out_dir):
    main(argv + ["--output_dir", str(out_dir), "--metrics_jsonl", str(out_dir / "m.jsonl")])
    rows = [json.loads(line) for line in (out_dir / "m.jsonl").read_text().splitlines()]
    imgdir = out_dir / "images"
    return rows, {os.path.relpath(os.path.join(r, f), imgdir): open(os.path.join(r, f), "rb").read()
                  for r, _, files in os.walk(imgdir) for f in files}


def _chunk_last(i, k, n):
    """The last step of the dispatch that runs step i of an epoch of n
    steps, K a dispatch; the tail past the last full dispatch runs alone."""
    full = n // k * k
    return i if i >= full else (i // k + 1) * k - 1


@pytest.mark.parametrize("name", sorted(RUN_TRAINING))
def test_fused_run_training_writes_the_unfused_rows_and_samples(tmp_path, name, capsys):
    """7 batches an epoch, 2 epochs, K = 3: two dispatches and a tail of one
    each epoch. The rows and log lines are the unfused loop's bit for bit.
    Every step is sampled. A sample of the step's images is its dispatch's
    last gen_imgs (the documented deviation): the unfused run's sample of
    that step. A sample of G on its own noise is taken after the dispatch:
    the unfused run's bit for bit at each dispatch's last step and in the
    tails. dragan's per-epoch grid holds the last logged batch's images
    (batch 6, in the tail): the unfused run's."""
    mod, source = RUN_TRAINING[name]
    argv = ["--synthetic_data", "--n_epochs", "2", "--max_batches", "7", "--batch_size", "8",
            "--latent_dim", str(LATENT), "--img_size", "16", "--sample_interval", "1",
            "--log_interval", "3"]
    runs, logs = {}, {}
    for k in (1, 3):
        runs[k] = _run_main(lambda a: mod.main(a, CPU), argv + ["--steps_per_dispatch", str(k)],
                            tmp_path / str(k))
        logs[k] = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch")]
    (rows1, png1), (rows3, png3) = runs[1], runs[3]
    assert rows3 == rows1 and [r["step"] for r in rows1] == list(range(14))
    assert logs[3] == logs[1] and len(logs[1]) == 6
    if source == "epoch":
        assert sorted(png3) == sorted(png1) == ["0.png", "1.png"]
        assert png3 == png1
        return
    dirs = ig_t.SAMPLE_DIRS if name == "infogan" else ("",)
    assert sorted(png3) == sorted(png1) == sorted(os.path.join(d, f"{i}.png") for d in dirs
                                                  for i in range(14))
    for d in dirs:
        for epoch in range(2):
            for i in range(7):
                last = _chunk_last(i, 3, 7)
                png = os.path.join(d, f"{epoch * 7 + i}.png")
                if source == "out":
                    assert png3[png] == png1[os.path.join(d, f"{epoch * 7 + last}.png")], png
                elif last == i:
                    assert png3[png] == png1[png], png


def _critic_argv(sample_interval, max_batches=15, n_epochs=2):
    return ["--synthetic_data", "--n_epochs", str(n_epochs), "--max_batches", str(max_batches),
            "--batch_size", str(B), "--latent_dim", str(LATENT), "--n_critic", str(N_CRITIC),
            "--sample_interval", str(sample_interval), "--log_interval", "2"]


@pytest.mark.parametrize("name", sorted(CRITIC))
def test_fused_critic_loop_writes_the_unfused_rows_and_samples(tmp_path, name, capsys):
    """15 batches an epoch with n_critic 2 and K = 3 units a dispatch: two
    dispatches (12 batches), a unit short of a dispatch and a batch short of
    a unit, unfused; two epochs. Both sampling branches: wgan_gp and
    wgan_div sample on G batches (batches_done += n_critic), wgan on every
    batch with the latest G output. Each sample is its dispatch's last unit's images."""
    mod = CRITIC[name][0]
    in_gstep = name != "wgan"
    interval = N_CRITIC if in_gstep else 1
    runs, logs = {}, {}
    for k in (1, 3):
        runs[k] = _run_main(lambda a: mod.main(a, CPU),
                            _critic_argv(interval) + ["--steps_per_dispatch", str(k)],
                            tmp_path / str(k))
        logs[k] = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch")]
    (rows1, png1), (rows3, png3) = runs[1], runs[3]
    assert rows3 == rows1 and [r["step"] for r in rows1] == list(range(30))
    assert {r["step"] for r in rows1 if "g_loss" in r} == {e * 15 + i for e in (0, 1)
                                                          for i in range(0, 15, 2)}
    assert logs[3] == logs[1] and logs[1]
    assert sorted(png3) == sorted(png1) and png1
    # A sample's tag is batches_done, which runs on across epochs: wgan_gp
    # saves on each of an epoch's 8 G batches (n_critic apart), wgan on each
    # of its 15 batches the latest unit's images. Units 0-5 of an epoch run
    # in two dispatches of 3; units 6 and 7 unfused.
    for tag in png1:
        bd = int(tag.split(".")[0])
        if in_gstep:
            epoch, unit = divmod(bd // N_CRITIC, 8)
        else:
            epoch, i = divmod(bd, 15)
            unit = i // N_CRITIC
        last = unit if unit >= 6 else (unit // 3 + 1) * 3 - 1
        # The unfused run's sample of unit ``last``'s own G batch.
        want = N_CRITIC * (epoch * 8 + last) if in_gstep else epoch * 15 + N_CRITIC * last
        assert png3[tag] == png1[f"{want}.png"], (tag, want)


@pytest.mark.parametrize("name", ["dcgan", "wgan_gp", "wgan", "wgan_div"])
def test_fused_rows_and_pngs_match_the_jax_fused_loop(tmp_path, name):
    """The port's fused loop and the JAX package's at the same config and
    K = 3: the same row steps and keys and the same PNG names (the values
    differ: the frameworks draw different numbers)."""
    if name == "dcgan":
        mods = (dc_t, dc_j)
        argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", "7", "--batch_size", "8",
                "--latent_dim", str(LATENT), "--img_size", "16", "--sample_interval", "2",
                "--log_interval", "0"]
    else:
        mods = CRITIC[name]
        argv = _critic_argv(3 if name == "wgan" else 4, n_epochs=1)
    argv += ["--steps_per_dispatch", "3"]
    got = {}
    for side, main in (("port", lambda a: mods[0].main(a, CPU)), ("jax", mods[1].main)):
        rows, pngs = _run_main(main, argv, tmp_path / side)
        got[side] = ([(r["step"], sorted(r)) for r in rows], sorted(pngs))
    assert got["port"] == got["jax"]
    assert got["port"][1]


# --- The notice of the loops that do not fuse --------------------------------


def test_per_step_loops_print_the_notice_and_fused_ones_do_not(capsys):
    cfg = dc_t.Config(steps_per_dispatch=4)
    StepObserver(cfg)
    assert "--steps_per_dispatch is not supported" in capsys.readouterr().out
    StepObserver(cfg, supports_fused_dispatch=True)
    StepObserver(dc_t.Config())
    assert capsys.readouterr().out == ""


def test_cyclegan_and_munit_print_the_notice_and_run_per_step(tmp_path, capsys, monkeypatch):
    """As in the JAX package (tpugan/train/loop.py:114-124), the im2im loops
    do not fuse: they print the notice and run every step."""
    from tpugan_torch.models import cyclegan as cg_t
    from tpugan_torch.models import munit as mu_t

    monkeypatch.setattr(cg_t, "train_device", lambda cfg, device=None: CPU)
    cg_t.main(["--img_height", "16", "--img_width", "16", "--n_residual_blocks", "1",
               "--synthetic_data", "--n_epochs", "1", "--max_batches", "2",
               "--steps_per_dispatch", "2", "--sample_interval", "0", "--log_interval", "1",
               "--output_dir", str(tmp_path / "cg")])
    out = capsys.readouterr().out
    assert "--steps_per_dispatch is not supported" in out
    assert sum(line.startswith("[Epoch 0/1] [Batch") for line in out.splitlines()) == 2
    mu_t.main(["--img_height", "64", "--img_width", "64", "--dim", "4", "--n_residual", "1",
               "--synthetic_data", "--n_epochs", "1", "--max_batches", "2",
               "--steps_per_dispatch", "2", "--sample_interval", "0", "--log_interval", "1",
               "--output_dir", str(tmp_path / "mu")], CPU)
    out = capsys.readouterr().out
    assert "--steps_per_dispatch is not supported" in out
    assert sum(line.startswith("[Epoch 0/1] [Batch") for line in out.splitlines()) == 2


# --- wgan against the JAX package --------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_modules(params, model_state):
    G = MLPGenerator((1, 28, 28), LATENT)
    D = MLPDiscriminator(784, sigmoid=False)
    load_jax_params(G, params["generator"], model_state["generator"])
    load_jax_params(D, params["discriminator"])
    return {"generator": G, "discriminator": D}


@pytest.fixture(scope="module")
def wgan_jax():
    """The JAX wgan's initial state, its d_step and g_step on one batch, and
    the z the d_step drew (``tpugan/models/_critic_family.py:66-67``)."""
    cfg = wg_j.Config(batch_size=B, latent_dim=LATENT, synthetic_data=True)
    mods = wg_j.build(cfg)
    state0 = wg_j.create_state(cfg, mods)
    d_step, g_step = wg_j.make_steps(cfg, mods)
    imgs = np.random.default_rng(5).integers(0, 255, (B, 28, 28, 1), np.uint8)
    _, k_z, _ = jax.random.split(state0.rng, 3)
    z = np.array(jax.random.normal(k_z, (B, LATENT)))
    state1, d_out = jax.jit(d_step)(state0, imgs, np.zeros(B, np.int32))
    state2, g_out = jax.jit(g_step)(state1, d_out["z"])
    assert np.array_equal(np.asarray(d_out["z"]), z)
    return {
        "cfg": cfg, "imgs": imgs, "z": z,
        "params0": _np_tree(state0.params), "stats0": _np_tree(state0.model_state),
        "params1": _np_tree(state1.params), "stats1": _np_tree(state1.model_state),
        "params2": _np_tree(state2.params), "stats2": _np_tree(state2.model_state),
        "d_loss": float(d_out["d_loss"]), "g_loss": float(g_out["g_loss"]),
        "gen_imgs": np.asarray(g_out["gen_imgs"]),
    }


def _assert_rmsprop_close(got, want, before, grads, lr, clip, what):
    """Parameters after one RMSprop step and the clip to ±``clip``: close to
    the JAX package's where the gradient is above 1e-6 of the largest; and
    everywhere within 10 lr (RMSprop's largest first step) of the clipped
    start, since the clip moves no two values further apart."""
    largest = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        settled = g.abs() > 1e-6 * largest
        np.testing.assert_allclose(got[k][settled], want[k][settled], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{what} {k}")
        moved = (got[k] - before[k].clamp(-clip, clip)).abs()
        assert float(moved.max()) <= 10 * lr * (1 + 1e-5), (what, k)


def test_wgan_d_step_with_the_clip_and_g_step_with_rmsprop_match_jax(wgan_jax):
    j = wgan_jax
    cfg = wg_t.Config(batch_size=B, latent_dim=LATENT, synthetic_data=True)
    modules = _port_modules(j["params0"], j["stats0"])
    state = wg_t.create_state(cfg, modules, CPU)
    assert isinstance(state.optimizers["generator"], torch.optim.RMSprop)
    d_step, g_step = wg_t.make_steps(cfg, state)
    before = {r: {k: v.detach().clone() for k, v in m.state_dict().items()}
              for r, m in modules.items()}
    state, d_out = d_step(state, torch.from_numpy(j["imgs"]), None, z=torch.from_numpy(j["z"]))
    d_grads = {k: p.grad.clone() for k, p in modules["discriminator"].named_parameters()}
    after_d = {k: v.detach().clone() for k, v in modules["discriminator"].state_dict().items()}
    state, g_out = g_step(state, d_out["z"])
    g_grads = {k: p.grad.clone() for k, p in modules["generator"].named_parameters()}
    np.testing.assert_allclose(float(d_out["d_loss"]), j["d_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(g_out["g_loss"]), j["g_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g_out["gen_imgs"].numpy(), j["gen_imgs"].transpose(0, 3, 1, 2),
                               atol=1e-5)
    # The clip: every critic parameter within ±clip_value after the d_step.
    assert all(float(v.abs().max()) <= cfg.clip_value for v in after_d.values())
    want1 = _port_modules(j["params1"], j["stats1"])["discriminator"].state_dict()
    _assert_rmsprop_close(after_d, want1, before["discriminator"], d_grads, cfg.lr,
                          cfg.clip_value, "critic")
    want2 = _port_modules(j["params2"], j["stats2"])
    _assert_rmsprop_close(modules["generator"].state_dict(), want2["generator"].state_dict(),
                          before["generator"], g_grads, cfg.lr, float("inf"), "generator")
    for k, v in modules["generator"].state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want2["generator"].state_dict()[k].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)


def test_wgan_config_flags_match_jax():
    import dataclasses

    got = {f.name: (f.default, f.type) for f in dataclasses.fields(wg_t.Config)}
    want = {f.name: (f.default, f.type) for f in dataclasses.fields(wg_j.Config)}
    assert got == want


def test_wgan_few_batch_main_writes_the_samples_of_jax(tmp_path):
    argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", "10", "--batch_size", "16",
            "--latent_dim", str(LATENT), "--sample_interval", "4", "--log_interval", "5"]
    got = {}
    for side, main in (("port", lambda a: wg_t.main(a, CPU)), ("jax", wg_j.main)):
        rows, pngs = _run_main(main, argv, tmp_path / side)
        got[side] = ([(r["step"], sorted(r)) for r in rows], sorted(pngs))
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
            assert all(b[:8] == b"\x89PNG\r\n\x1a\n" for b in pngs.values())
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["0.png", "4.png", "8.png"]


def test_wgan_run_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        wg_t.main(["--synthetic_data", "--output_dir", str(tmp_path)])


def test_cli_lists_wgan(capsys):
    from tpugan_torch.__main__ import main

    assert main(["list"]) == 0
    assert "wgan" in capsys.readouterr().out.split()


def test_optimizers_are_capturable_on_cuda_only():
    from tpugan_torch.train.optim import capturable

    assert capturable("cuda") == {"capturable": True} and capturable(CPU) == {}
    for name in sorted(CRITIC):
        _, state, _ = _critic(CRITIC[name][0])
        assert not any(g["capturable"] for o in state.optimizers.values()
                       for g in o.param_groups)
