"""The observability flags of the port against the JAX package, on the CPU:
``--profile_dir``/``--profile_steps``, ``--debug_numerics`` and
``--ragged_last_batch`` (``tpugan_torch/train/loop.py:StepObserver``,
``tpugan_torch/data/loader.py``), and that every kind of training loop of the
port ticks its observer once a dispatch.

- The profile window: the dispatches the port traces equal the ticks between
  the JAX observer's ``start_trace`` and ``stop_trace``, at K = 1 and 4 steps
  a dispatch and at the critic family's K * (n_critic + 1).
- The synchronous loader yields the batches of the threaded one, byte for
  byte (``tests/test_observability.py:81-117``).
- The ragged tail's step against one jit of the JAX step on the same tail
  batch (a tail of 1 included), with JAX's draws passed in; tolerances as
  ``tests/test_torch_port_wgan_gp.py`` and ``tests/test_torch_port_dcgan.py``
  state them, float32 on both sides with sums in different orders: losses
  1e-5 relative, generated images 1e-5 absolute, parameters after the
  update 1e-3 relative and 5e-5 absolute (WGAN-GP), gradients 1e-3 relative
  plus 1e-4 of the module's largest gradient absolute and running statistics
  1e-4 relative and 1e-6 absolute (DCGAN).
- A fused loop with a ragged tail writes the rows of the unfused loop bit for
  bit (the CPU runs the K steps of a dispatch in a Python loop).
"""

import glob
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread, run_main  # noqa: F401 (autouse fixture)
from test_torch_port_dcgan import _jax_grads, _jax_masks, _port_modules
from test_torch_port_wgan_gp import _port_modules as _wgan_modules

import tpugan.train.loop as loop_j
from tpugan.losses import bce as bce_j
from tpugan.models import dcgan as dc_j
from tpugan.models import wgan_gp as wg_j
from tpugan_torch.data import loader as loader_t
from tpugan_torch.data.loader import DeviceLoader, UnpairedLoader, ZipLoader
from tpugan_torch.models import cluster_gan as clg_t
from tpugan_torch.models import cyclegan as cyg_t
from tpugan_torch.models import dcgan as dc_t
from tpugan_torch.models import dualgan as du_t
from tpugan_torch.models import esrgan as es_t
from tpugan_torch.models import gan as gan_t
from tpugan_torch.models import srgan as sr_t
from tpugan_torch.models import stargan as sg_t
from tpugan_torch.models import wgan_gp as wg_t
from tpugan_torch.train import loop as loop_t
from tpugan_torch.utils.config import config_from_args

CPU = torch.device("cpu")
LATENT = 16
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-3, 5e-5


@pytest.fixture(autouse=True)
def process_modes():
    """Each test from the default modes, and back to them after."""
    loader_t.set_synchronous(False)
    loader_t.set_drop_last(True)
    yield
    loader_t.set_synchronous(False)
    loader_t.set_drop_last(True)
    assert not torch.is_anomaly_enabled()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# --- --profile_dir ---------------------------------------------------------------------------


def _jax_window(monkeypatch, cfg, dispatch_steps, ticks):
    """The ticks of the JAX observer at which it starts and stops its trace."""
    marks = {}
    obs = loop_j.StepObserver(cfg, supports_fused_dispatch=True, dispatch_steps=dispatch_steps)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: marks.setdefault("start",
                                                                                 obs._calls))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: marks.setdefault("stop", obs._calls))
    for _ in range(ticks):
        obs.profile_tick({"x": jnp.zeros(())})
    obs.close()
    return marks["start"], marks["stop"]


@pytest.mark.parametrize("k, n_critic, steps", [(1, None, 5), (4, None, 8), (4, None, 5),
                                                (3, 5, 40)],
                         ids=["k1", "k4", "k4-ragged-window", "critic-k3"])
def test_profile_window_equals_the_jax_observers(tmp_path, monkeypatch, k, n_critic, steps):
    """The port traces dispatches [1, 1 + ceil(N / S)), S the steps a
    dispatch (the critic family's K * (n_critic + 1)): the ticks from the
    JAX observer's start to its stop. Each traced dispatch is a named range
    in the TensorBoard trace the port writes."""
    ds_jax = k * (n_critic + 1) if n_critic else None  # None: the JAX observer takes K
    ds = ds_jax or k
    cfg = types.SimpleNamespace(profile_dir=str(tmp_path), profile_steps=steps,
                                steps_per_dispatch=k)
    start, stop = _jax_window(monkeypatch, cfg, ds_jax, 12)
    obs = loop_t.StepObserver(cfg, supports_fused_dispatch=True, dispatch_steps=ds)
    for _ in range(12):
        obs.profile_tick()
    obs.close()
    assert obs.traced == list(range(start, stop))
    assert len(obs.traced) == -(-steps // ds)
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {f"tpugan.dispatch.{n}" for n in obs.traced} <= names
    assert f"tpugan.dispatch.{stop}" not in names and "tpugan.dispatch.0" not in names


def test_a_loop_that_does_not_fuse_counts_one_step_a_dispatch():
    """The bespoke loops run one step a dispatch whatever
    ``--steps_per_dispatch`` says, so their window is ``--profile_steps``
    dispatches. The JAX observer divides by K there too, and so traces
    fewer steps than asked in those loops; the port counts what it runs."""
    cfg = types.SimpleNamespace(profile_dir="x", profile_steps=8, steps_per_dispatch=4)
    assert loop_t.StepObserver(cfg).profile_dispatches == 8
    fused = loop_t.StepObserver(cfg, supports_fused_dispatch=True, dispatch_steps=4)
    assert fused.profile_dispatches == 2


def test_a_cpu_profile_run_writes_a_trace_of_its_window(tmp_path, capsys):
    """``dcgan.main`` fused (K = 2) with ``--profile_steps 3``: dispatches 1
    and 2 traced, in one TensorBoard trace file that parses as JSON, with
    the port's spans on inside the window (the stacking of a dispatch's
    batches)."""
    argv = ["--synthetic_data", "--img_size", "16", "--batch_size", "8", "--latent_dim", "8",
            "--n_epochs", "1", "--max_batches", "8", "--sample_interval", "0",
            "--steps_per_dispatch", "2", "--profile_dir", str(tmp_path / "prof"),
            "--profile_steps", "3", "--output_dir", str(tmp_path)]
    dc_t.main(argv, CPU)
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {n for n in names if str(n).startswith("tpugan.dispatch.")} == {
        "tpugan.dispatch.1", "tpugan.dispatch.2"}
    assert "tpugan.loop.stack" in names
    assert any("conv" in str(n) for n in names)


# --- every loop ticks its observer -----------------------------------------------------------

# loop kind: (module, argv, batches, dispatches); the fused kind without
# --debug_numerics, which would run it one step a dispatch.
LOOPS = {
    "run_training": (gan_t, ["--img_size", "16", "--batch_size", "8", "--latent_dim", "8"], 3, 3),
    "run_training fused": (gan_t, ["--img_size", "16", "--batch_size", "8", "--latent_dim", "8",
                                   "--steps_per_dispatch", "3"], 9, 3),
    "critic family": (wg_t, ["--batch_size", "8", "--latent_dim", "8", "--n_critic", "2"], 3, 3),
    "_im2im_common": (cyg_t, ["--img_height", "32", "--img_width", "32", "--n_residual_blocks",
                              "1", "--checkpoint_interval", "-1"], 3, 3),
    "stargan": (sg_t, ["--img_height", "64", "--img_width", "64", "--residual_blocks", "1",
                       "--batch_size", "2", "--n_critic", "2", "--checkpoint_interval", "-1"],
                3, 3),
    "cluster_gan": (clg_t, ["--batch_size", "8", "--latent_dim", "8", "--n_critic", "2"], 3, 3),
    "dualgan": (du_t, ["--batch_size", "1", "--n_critic", "2", "--checkpoint_interval", "-1"],
                3, 3),
    "srgan": (sr_t, ["--batch_size", "2", "--hr_height", "32", "--hr_width", "32",
                     "--checkpoint_interval", "-1"], 3, 3),
    "esrgan": (es_t, ["--batch_size", "2", "--hr_height", "32", "--hr_width", "32",
                      "--residual_blocks", "1", "--warmup_batches", "1",
                      "--checkpoint_interval", "-1"], 3, 3),
}


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_each_loop_ticks_its_observer_once_a_dispatch(tmp_path, monkeypatch, kind):
    """An epoch of each kind of loop under the three flags: one observer,
    one tick a dispatch, the dispatches after the warm-up in its window
    traced (``--profile_steps`` 2 over its steps a dispatch), every step
    checked under ``--debug_numerics``, and anomaly mode off after."""
    mod, extra, n_batches, dispatches = LOOPS[kind]
    debug = kind != "run_training fused"
    observers, checked = [], []
    init, wrap = loop_t.StepObserver.__init__, loop_t.StepObserver.checked

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        observers.append(self)

    def count(self, fn):
        inner = wrap(self, fn)
        return lambda *a, **kw: (checked.append(1), inner(*a, **kw))[1]

    monkeypatch.setattr(loop_t.StepObserver, "__init__", record)
    monkeypatch.setattr(loop_t.StepObserver, "checked", count)
    sample = ["--sample_interval", "0"] if "sample_interval" in mod.Config.__dataclass_fields__ \
        else []
    argv = ["--synthetic_data", "--n_epochs", "1", "--max_batches", str(n_batches), *sample,
            "--log_interval", "0", "--profile_dir",
            str(tmp_path / "prof"), "--profile_steps", "2", "--ragged_last_batch", *extra]
    mod.main(argv + ["--debug_numerics"] * debug + ["--output_dir", str(tmp_path)], CPU)
    (obs,) = observers
    assert obs._calls == dispatches
    assert obs.traced == list(range(1, min(dispatches, 1 + obs.profile_dispatches)))
    assert glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert obs.debug_numerics == debug and len(checked) >= n_batches


# --- --debug_numerics ------------------------------------------------------------------------


def _collect(loader):
    return [tuple(a.numpy().copy() for a in b) for b in loader.epoch(0)]


def test_synchronous_loaders_yield_the_threaded_batches(monkeypatch):
    """DeviceLoader, UnpairedLoader and ZipLoader: the same batches with and
    without the producer thread, and no thread started in the synchronous
    mode."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, (37, 8, 8, 1), np.uint8)
    other = rng.integers(0, 255, (23, 8, 8, 1), np.uint8)
    labels = np.arange(37, dtype=np.int32)

    def loaders():
        return [DeviceLoader([data, labels], 8, CPU, seed=3),
                UnpairedLoader(data, other, 8, CPU, seed=4),
                ZipLoader(DeviceLoader([data], 8, CPU, seed=5), DeviceLoader([other], 4, CPU))]

    threaded = [_collect(l) for l in loaders()]
    loader_t.set_synchronous(True)

    def no_thread(*a, **kw):
        raise AssertionError("a producer thread in the synchronous mode")

    monkeypatch.setattr(threading, "Thread", no_thread)
    synchronous = [_collect(l) for l in loaders()]
    assert [len(b) for b in threaded] == [4, 4, 4]
    for ta, sa in zip(threaded, synchronous):
        assert len(ta) == len(sa)
        for bt, bs in zip(ta, sa):
            for a, b in zip(bt, bs):
                np.testing.assert_array_equal(a, b)


def test_flags_wire_the_process_modes():
    """``config_from_args`` (and ``train_device``, for a config built in
    code) set the synchronous mode and ``drop_last`` from the flags, on and
    off."""
    assert not loader_t._SYNCHRONOUS and loader_t._DROP_LAST
    cfg = config_from_args(gan_t.Config, ["--debug_numerics", "--ragged_last_batch"])
    assert cfg.debug_numerics and cfg.ragged_last_batch
    assert loader_t._SYNCHRONOUS and not loader_t._DROP_LAST
    imgs = np.zeros((10, 1, 1, 1), np.uint8)
    assert len(DeviceLoader([imgs], 4, CPU)) == 3
    loop_t.train_device(gan_t.Config(), CPU)
    assert not loader_t._SYNCHRONOUS and len(DeviceLoader([imgs], 4, CPU)) == 2


def _nan_step(state, x):
    w = state["w"]
    loss = (w * x).sum()
    loss.backward()
    return state, {"loss": loss.detach()}


def test_debug_numerics_raises_floating_point_error_on_a_nan():
    """A NaN in the backward (anomaly mode's check) and a NaN scalar output
    both raise FloatingPointError naming what was not finite; without the
    flag the step runs; anomaly mode is on only inside the checked step."""
    cfg = types.SimpleNamespace(debug_numerics=True)
    obs = loop_t.StepObserver(cfg)
    state = {"w": torch.ones(3, requires_grad=True)}
    x = torch.tensor([1.0, float("nan"), 2.0])
    with pytest.raises(FloatingPointError, match="nan values"):
        obs.checked(_nan_step)(state, x)
    with pytest.raises(FloatingPointError, match="'g_loss'"):
        obs.checked(lambda s: (s, {"d_loss": torch.tensor(1.0),
                                   "g_loss": torch.tensor(float("inf"))}))(state)
    assert not torch.is_anomaly_enabled()
    assert loop_t.first_nonfinite({"a": torch.tensor(1.0), "img": torch.ones(2)}) is None
    plain = loop_t.StepObserver(types.SimpleNamespace())
    _, out = plain.checked(_nan_step)(state, x)
    assert torch.isnan(out["loss"])


def test_debug_numerics_raises_in_a_training_run(tmp_path, monkeypatch):
    """``wgan_gp.main`` with ``--debug_numerics`` and a NaN in the
    generator's first weight stops at the first critic step with
    FloatingPointError, from anomaly mode's check of the backward (a loss
    with a range check of its own, such as binary cross-entropy, raises its
    own error in the forward first)."""
    build = wg_t.build

    def poisoned(cfg, device):
        modules = build(cfg, device)
        with torch.no_grad():
            next(modules["generator"].parameters())[0, 0] = float("nan")
        return modules

    monkeypatch.setattr(wg_t, "build", poisoned)
    argv = ["--synthetic_data", "--batch_size", "8", "--latent_dim", "8", "--n_epochs", "1",
            "--max_batches", "3", "--sample_interval", "0", "--debug_numerics",
            "--metrics_jsonl", str(tmp_path / "m.jsonl"), "--output_dir", str(tmp_path)]
    with pytest.raises(FloatingPointError, match="nan values"):
        wg_t.main(argv, CPU)
    assert (tmp_path / "m.jsonl").read_text() == ""


def test_debug_numerics_runs_fused_loops_one_step_a_dispatch(tmp_path, capsys):
    """Under ``--debug_numerics`` a fused loop prints the notice and runs one
    step a dispatch: the rows of the unfused run, bit for bit."""
    base = ["--synthetic_data", "--img_size", "16", "--batch_size", "8", "--latent_dim", "8",
            "--n_epochs", "1", "--max_batches", "4", "--sample_interval", "0", "--log_interval",
            "0", "--debug_numerics"]
    _, plain, _ = run_main(lambda a: gan_t.main(a, CPU), base, tmp_path / "a")
    capsys.readouterr()
    _, fused, _ = run_main(lambda a: gan_t.main(a, CPU), base + ["--steps_per_dispatch", "2"],
                           tmp_path / "b")
    assert "--debug_numerics runs one step per dispatch" in capsys.readouterr().out
    assert fused == plain and len(plain) == 4


# --- --ragged_last_batch ---------------------------------------------------------------------


def test_a_ragged_epoch_covers_every_sample():
    """``set_drop_last(False)``: the tail batch of n % batch_size, every
    sample once an epoch, in DeviceLoader and UnpairedLoader; the default
    drops it."""
    imgs = np.arange(10, dtype=np.uint8).reshape(10, 1, 1, 1)
    labels = np.arange(10, dtype=np.int32)
    assert len(DeviceLoader([imgs, labels], 4, CPU)) == 2
    loader_t.set_drop_last(False)
    loader = DeviceLoader([imgs, labels], 4, CPU, seed=0)
    assert len(loader) == 3
    batches = list(loader.epoch(0))
    assert [int(b[0].shape[0]) for b in batches] == [4, 4, 2]
    assert sorted(torch.cat([b[1] for b in batches]).tolist()) == list(range(10))
    unpaired = UnpairedLoader(imgs, imgs[:3], 4, CPU)
    got = list(unpaired.epoch(0))
    assert [int(a.shape[0]) for a, _ in got] == [4, 4, 2]
    assert [int(b.shape[0]) for _, b in got] == [4, 4, 2]
    assert sorted(torch.cat([a for a, _ in got]).ravel().tolist()) == list(range(10))


def _wgan_tail(t):
    """One JAX d_step and g_step on a tail batch of ``t``, with their draws."""
    cfg = wg_j.Config(batch_size=8, latent_dim=LATENT, synthetic_data=True)
    mods = wg_j.build(cfg)
    state0 = wg_j.create_state(cfg, mods)
    d_step, g_step = wg_j.make_steps(cfg, mods)
    imgs = np.random.default_rng(7).integers(0, 255, (t, 28, 28, 1), np.uint8)
    _, k_z, k_pen = jax.random.split(state0.rng, 3)
    z = np.array(jax.random.normal(k_z, (t, LATENT)))
    alpha = np.array(jax.random.uniform(k_pen, (t, 1, 1, 1), jnp.float32))
    state1, d_out = jax.jit(d_step)(state0, imgs, np.zeros(t, np.int32))
    state2, g_out = jax.jit(g_step)(state1, d_out["z"])
    return (imgs, z, alpha, _np(state0.params), _np(state0.model_state), _np(state2.params),
            _np(state2.model_state), d_out, g_out)


@pytest.mark.parametrize("t", [1, 3])
def test_wgan_gp_tail_step_matches_jax(t):
    """The port's d_step and g_step on a tail of ``t`` (the MLP generator's
    BatchNorm1d over one sample included) against the JAX steps, with
    JAX's z and alpha; the port's closed-form penalty, its plain version on
    the CPU."""
    imgs, z, alpha, p0, s0, p2, s2, d_out_j, g_out_j = _wgan_tail(t)
    cfg = wg_t.Config(batch_size=8, latent_dim=LATENT, synthetic_data=True)
    modules = _wgan_modules(p0, s0)
    state = wg_t.create_state(cfg, modules, CPU)
    d_step, g_step = wg_t.make_steps(cfg, state)
    state, d_out = d_step(state, torch.from_numpy(imgs), None, z=torch.from_numpy(z),
                          alpha=torch.from_numpy(alpha))
    state, g_out = g_step(state, d_out["z"])
    np.testing.assert_allclose(float(d_out["d_loss"]), float(d_out_j["d_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(g_out["g_loss"]), float(g_out_j["g_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(g_out["gen_imgs"].numpy(),
                               np.asarray(g_out_j["gen_imgs"]).transpose(0, 3, 1, 2), atol=1e-5)
    want = _wgan_modules(p2, s2)
    for role in ("generator", "discriminator"):
        got_sd, want_sd = modules[role].state_dict(), want[role].state_dict()
        for k in want_sd:
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=f"{role} {k}")


def test_dcgan_tail_of_one_matches_jax():
    """One DCGAN step at 16px on a tail of one sample, where the
    discriminator's last BatchNorm sees one value a channel (1x1 maps):
    losses, images, gradients and running statistics against one jit of the
    JAX step, with JAX's z and Dropout2d masks."""
    size, t = 16, 1
    cfg_j = dc_j.Config(img_size=size, batch_size=8, latent_dim=LATENT, synthetic_data=True)
    cfg_t = dc_t.Config(img_size=size, batch_size=8, latent_dim=LATENT, synthetic_data=True)
    mods = dc_j.build(cfg_j)
    state0 = dc_j.create_state(cfg_j, mods)
    imgs = np.random.default_rng(5).integers(0, 256, (t, size, size, 1), dtype=np.uint8)
    step = dc_j.make_step(cfg_j, mods)

    def step_and_grads(s, x):
        new_state, out = step(s, x, jnp.zeros(t, jnp.int32))
        return new_state, out, _jax_grads(cfg_j, mods, s, x, bce_j)

    state1, out, grads = jax.jit(step_and_grads)(state0, imgs)
    _, k_z, *k_do = jax.random.split(state0.rng, 5)
    p0, s0 = _np(state0.params), _np(state0.model_state)
    masks = [_jax_masks(mods["discriminator"], p0["discriminator"], s0["discriminator"], k,
                        imgs.shape) for k in k_do]
    z = np.array(jax.random.normal(k_z, (t, LATENT)))
    modules = _port_modules(dc_t, cfg_t, p0, s0)
    state = dc_t.create_state(cfg_t, modules, CPU)
    state, out_t = dc_t.make_step(cfg_t, state)(
        state, torch.from_numpy(imgs), None, z=torch.from_numpy(z),
        masks=[[torch.from_numpy(m) for m in ms] for ms in masks])
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(out_t[k]), float(out[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(out_t["gen_imgs"].numpy(),
                               np.asarray(out["gen_imgs"]).transpose(0, 3, 1, 2), atol=1e-5)
    want_g = _port_modules(dc_t, cfg_t, _np(grads), s0)
    want_s = _port_modules(dc_t, cfg_t, _np(state1.params), _np(state1.model_state))
    for role in ("generator", "discriminator"):
        want = dict(want_g[role].named_parameters())
        floor = 1e-4 * max(float(g.detach().abs().max()) for g in want.values())
        for k, p in modules[role].named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[k].detach().numpy(), rtol=1e-3,
                                       atol=floor, err_msg=f"{role} {k}")
        got_sd, want_sd = modules[role].state_dict(), want_s[role].state_dict()
        for k in want_sd:
            if "running" in k:
                np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{role} {k}")


@pytest.mark.parametrize("name, batch, k", [("gan", 1000, 2), ("wgan_gp", 292, 2)])
def test_fused_ragged_epoch_writes_the_unfused_rows(tmp_path, name, batch, k):
    """A whole epoch of the 4096-image synthetic set with its ragged tail
    (gan: 2 dispatches of K = 2, a full batch and a tail of 96, eager; wgan_gp: 14 full
    batches and a tail of 8, the tail landing in the third schedule unit,
    which is flushed unfused): rows of every batch, bit for bit the unfused
    run's, the tail's included."""
    mod = {"gan": gan_t, "wgan_gp": wg_t}[name]
    base = ["--synthetic_data", "--batch_size", str(batch), "--latent_dim", "8", "--n_epochs",
            "1", "--sample_interval", "0", "--log_interval", "0", "--ragged_last_batch"]
    _, plain, _ = run_main(lambda a: mod.main(a, CPU), base, tmp_path / "a")
    _, fused, _ = run_main(lambda a: mod.main(a, CPU), base + ["--steps_per_dispatch", str(k)],
                           tmp_path / "b")
    assert len(plain) == -(-4096 // batch)
    assert fused == plain
    assert all(np.isfinite(v) for r in plain for v in r.values())
