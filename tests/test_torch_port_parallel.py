"""The port's data parallelism (``tpugan_torch/parallel/``) on the CPU with
two gloo ranks, against the JAX package's step sharded over two devices
(``data_mesh(jax.devices()[:2])`` of conftest's eight) and against the
port's single process.

The JAX steps run here; their draws (z, the Dropout2d keep masks, the GP's
alpha) are read off their key splits, as ``tests/test_torch_port_dcgan.py``
reads them, and passed with the JAX initial weights to two rank processes
(``tests/_torch_dp_ranks.py``, one spawn for every case of this file, with
``torchrun``'s environment). Each rank takes its rows of the global draws and
batch. The single process runs the same step on the whole batch here.

Tolerances, float32 with sums in different orders:
- global BatchNorm against ``nn.BatchNorm1d``/``2d`` on the concatenated
  batch: outputs and input gradients 1e-5 relative and absolute; the affine
  gradients 1e-5 relative and 1e-4 absolute (sums of 50-200 products of unit
  scale); running statistics 1e-5 relative, 1e-6 absolute. In bf16 one bf16
  ulp (2^-8) of the largest output or input gradient, and 1e-3 relative on
  the affine gradients;
- steps, as ``tests/test_parallel.py`` holds the JAX sharded step to the
  single device: losses 1e-4 relative (dcgan 2e-4), parameters and running
  statistics 1e-3 relative and 1e-5 absolute. A parameter whose gradient is
  below 1e-4 of its module's largest is held to 2*lr instead: Adam's first
  step is lr*g/(|g|+eps), which turns rounding noise of a zero gradient (a
  bias that feeds a BatchNorm) into +-lr, as the single-process tests say;
- generated images 1e-5 absolute; the loaders' shares bit for bit; the CLI's
  PNGs within one level of 255 and its logged losses 1e-3 relative (four
  steps from parameters that agree to 1e-5).
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_dcgan import _jax_masks

import _torch_dp_ranks as ranks
from tpugan.models import dcgan as dc_j
from tpugan.models import gan as gan_j
from tpugan.models import wgan_gp as wg_j
from tpugan.parallel import batch_sharding, data_mesh, shard_state
from tpugan_torch.__main__ import one_device_notice
from tpugan_torch.data.im2im import resize_crop_flip_transform
from tpugan_torch.data.loader import DeviceLoader, UnpairedLoader
from tpugan_torch.io.images import decode_png
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import cgan, dcgan, gan, pix2pix, softmax_gan, wgan_gp
from tpugan_torch.parallel.dryrun import dryrun_multichip
from tpugan_torch.parallel.mesh import auto_sharding

CPU = torch.device("cpu")
B, LATENT = 8, 16
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
CLI = ["--synthetic_data", "--max_batches", "4", "--n_epochs", "1", "--batch_size", str(B),
       "--img_size", "32", "--latent_dim", str(LATENT), "--sample_interval", "2",
       "--log_interval", "1"]
# name: (port module, JAX module, img_size, loss rtol)
STEPS = {"gan": (gan, gan_j, 28, 1e-4), "dcgan": (dcgan, dc_j, 32, 2e-4)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _sharded(fn, state, *batch):
    """``fn`` jitted on ``state`` replicated and ``batch`` sharded over two
    devices, as ``tests/test_parallel.py`` runs it."""
    mesh = data_mesh(jax.devices()[:2])
    return jax.jit(fn)(shard_state(state, mesh),
                       *(jax.device_put(x, batch_sharding(mesh)) for x in batch))


def _port_sd(mod_t, cfg, params, stats):
    """A JAX tree in the port's layout: {role: state_dict}."""
    modules = mod_t.build(cfg, CPU)
    for role, m in modules.items():
        load_jax_params(m, params[role], stats.get(role))
    return {role: {k: v.clone() for k, v in m.state_dict().items()} for role, m in modules.items()}


def _single(mod_t, cfg, init, imgs, **draws):
    """The port's single process: one step on the whole batch."""
    modules = mod_t.build(cfg, CPU)
    for role, sd in init.items():
        modules[role].load_state_dict(sd)
    state = mod_t.create_state(cfg, modules, CPU)
    state, out = mod_t.make_step(cfg, state)(state, imgs, None, **draws)
    return {"d_loss": out["d_loss"], "g_loss": out["g_loss"], "gen_imgs": out["gen_imgs"],
            "state": {r: m.state_dict() for r, m in modules.items()}}


def _template_b(name):
    mod_t, mod_j, size, _ = STEPS[name]
    cfg_j = mod_j.Config(img_size=size, batch_size=B, latent_dim=LATENT, synthetic_data=True)
    cfg_t = mod_t.Config(img_size=size, batch_size=B, latent_dim=LATENT, synthetic_data=True)
    mods = mod_j.build(cfg_j)
    state0 = mod_j.create_state(cfg_j, mods)
    imgs = np.random.default_rng(5).integers(0, 256, (B, size, size, 1), dtype=np.uint8)
    state1, out = _sharded(mod_j.make_step(cfg_j, mods), state0, imgs, np.zeros(B, np.int32))
    _, k_z, *k_do = jax.random.split(state0.rng, 5)
    params0, stats0 = _np(state0.params), _np(state0.model_state)
    draws = {"z": torch.from_numpy(np.array(jax.random.normal(k_z, (B, LATENT))))}
    if name == "dcgan":
        draws["masks"] = [[torch.from_numpy(m) for m in _jax_masks(
            mods["discriminator"], params0["discriminator"], stats0["discriminator"], k,
            imgs.shape)] for k in k_do]
    init = _port_sd(mod_t, cfg_t, params0, stats0)
    payload = {"cfg": cfg_t, "init": init, "imgs": torch.from_numpy(imgs), **draws}
    jax_out = {"d_loss": float(out["d_loss"]), "g_loss": float(out["g_loss"]),
               "gen_imgs": _nchw(out["gen_imgs"]),
               "state": _port_sd(mod_t, cfg_t, _np(state1.params), _np(state1.model_state))}
    return payload, jax_out, _single(mod_t, cfg_t, init, payload["imgs"], **draws)


def _wgan_gp():
    os.environ.pop("TPUGAN_PALLAS_GP", None)  # the JAX default, generic penalty
    cfg_j = wg_j.Config(batch_size=B, latent_dim=LATENT, synthetic_data=True)
    cfg_t = wgan_gp.Config(batch_size=B, latent_dim=LATENT, synthetic_data=True)
    mods = wg_j.build(cfg_j)
    state0 = wg_j.create_state(cfg_j, mods)
    d_step, g_step = wg_j.make_steps(cfg_j, mods)
    imgs = np.random.default_rng(6).integers(0, 256, (B, 28, 28, 1), dtype=np.uint8)
    _, k_z, k_pen = jax.random.split(state0.rng, 3)
    z = np.array(jax.random.normal(k_z, (B, LATENT)))
    alpha = np.array(jax.random.uniform(k_pen, (B, 1, 1, 1)))
    state1, d_out = _sharded(d_step, state0, imgs, np.zeros(B, np.int32))
    state2, g_out = jax.jit(g_step)(state1, d_out["z"])
    init = _port_sd(wgan_gp, cfg_t, _np(state0.params), _np(state0.model_state))
    payload = {"cfg": cfg_t, "init": init, "imgs": torch.from_numpy(imgs),
               "z": torch.from_numpy(z), "alpha": torch.from_numpy(alpha)}
    jax_out = {"d_loss": float(d_out["d_loss"]), "g_loss": float(g_out["g_loss"]),
               "gen_imgs": _nchw(g_out["gen_imgs"]),
               "state": _port_sd(wgan_gp, cfg_t, _np(state2.params), _np(state2.model_state))}
    modules = wgan_gp.build(cfg_t, CPU)
    for role, sd in init.items():
        modules[role].load_state_dict(sd)
    state = wgan_gp.create_state(cfg_t, modules, CPU)
    d_t, g_t = wgan_gp.make_steps(cfg_t, state)
    state, d_o = d_t(state, payload["imgs"], None, z=payload["z"], alpha=payload["alpha"])
    state, g_o = g_t(state, d_o["z"])
    single = {"d_loss": d_o["d_loss"], "g_loss": g_o["g_loss"], "gen_imgs": g_o["gen_imgs"],
              "state": {r: m.state_dict() for r, m in modules.items()}}
    return payload, jax_out, single


BN_CASES = {  # name: (global shape, eps, dtype)
    "bn2d_f32": ((8, 6, 5, 5), 1e-5, torch.float32),
    "bn1d_f32": ((8, 12), 0.8, torch.float32),
    "bn2d_bf16": ((8, 6, 5, 5), 0.8, torch.bfloat16),
    "bn1d_bf16": ((8, 12), 1e-5, torch.bfloat16),
    "bn1d_one_value": ((2, 5), 1e-5, torch.float32),
    "bn2d_one_value": ((2, 5, 1, 1), 0.8, torch.float32),
}


def _bn_spec(name):
    shape, eps, dtype = BN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    c = shape[1]
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1.5).astype(np.float32))
    state = {"weight": torch.from_numpy(rng.normal(1, 0.3, c).astype(np.float32)),
             "bias": torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)),
             "running_mean": torch.from_numpy(rng.normal(0, 1, c).astype(np.float32)),
             "running_var": torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32)),
             "num_batches_tracked": torch.tensor(3)}
    gy = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return {"x": x, "gy": gy, "eps": eps, "dtype": dtype, "state": state}


def _loader_spec():
    rng = np.random.default_rng(8)
    return {"images": rng.integers(0, 256, (40, 16, 16, 1), dtype=np.uint8),
            "labels": np.arange(40, dtype=np.int64),
            "a": rng.integers(0, 256, (30, 16, 16, 3), dtype=np.uint8),
            "b": rng.integers(0, 256, (25, 16, 16, 3), dtype=np.uint8),
            "batch": 6, "ragged_n": 20}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX sharded steps and the port's single process here, then every
    case of ``tests/_torch_dp_ranks.py:units`` in one spawn of two ranks."""
    refs = {name: _template_b(name) for name in STEPS}
    refs["wgan_gp"] = _wgan_gp()
    own = {"cfg": dcgan.Config(img_size=32, batch_size=B, latent_dim=LATENT, synthetic_data=True)}
    own["init"] = {r: m.state_dict() for r, m in dcgan.build(own["cfg"], CPU).items()}
    own["imgs"] = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (B, 32, 32, 1), dtype=np.uint8))
    payload = {name: r[0] for name, r in refs.items()}
    payload.update(bn={name: _bn_spec(name) for name in BN_CASES}, dcgan_own_draws=own,
                   loader=_loader_spec(), cli=CLI)
    work = str(tmp_path_factory.mktemp("dp_units"))
    got = ranks.spawn("units", payload, work)
    single_dir = os.path.join(work, "single")
    dcgan.main(CLI + ["--output_dir", single_dir,
                      "--metrics_jsonl", os.path.join(single_dir, "metrics.jsonl")], "cpu")
    return {"payload": payload, "refs": refs, "ranks": got, "single_dir": single_dir,
            "own_single": _single(dcgan, own["cfg"], own["init"], own["imgs"])}


def _held(got_sd, want_sd, grads, lr, what, counts=True):
    """``got_sd`` against ``want_sd`` at the step tolerances (module
    docstring); ``grads`` decide which parameters are above the noise.
    ``counts`` False skips ``num_batches_tracked``, which the JAX layer
    does not keep."""
    assert list(got_sd) == list(want_sd), what
    noise = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    for k, want in want_sd.items():
        got = got_sd[k]
        if k.endswith("num_batches_tracked"):
            assert not counts or int(got) == int(want), f"{what} {k}"
            continue
        diff = (got - want).abs()
        bound = PARAM_ATOL + PARAM_RTOL * want.abs()
        if k in grads:
            quiet = grads[k].abs() <= noise
            bound = torch.where(quiet, bound + 2 * lr, bound)
        bad = diff > bound
        assert not bad.any(), f"{what} {k}: {int(bad.sum())} of {bad.numel()} off, worst " \
                              f"{float(diff.max()):.3e}"


def _both_ranks_equal(a, b, what):
    """Every tensor of two ranks' results equal, bit for bit."""
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), f"{what} {k} differs across ranks"
        elif isinstance(a[k], dict):
            _both_ranks_equal(a[k], b[k], f"{what} {k}")


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_global_batch_norm_matches_torch_on_the_concatenated_batch(run, name):
    spec = run["payload"]["bn"][name]
    ref = (torch.nn.BatchNorm1d if spec["x"].dim() == 2 else torch.nn.BatchNorm2d)(
        spec["x"].shape[1], spec["eps"])
    ref.load_state_dict(spec["state"])
    x = spec["x"].to(spec["dtype"]).requires_grad_(True)
    y = ref(x)
    (y.float() * spec["gy"]).sum().backward()
    got = [r["bn"][name] for r in run["ranks"]]
    y_dp = torch.cat([g["y"] for g in got])
    dx_dp = torch.cat([g["dx"] for g in got])
    assert y_dp.dtype == spec["dtype"] and dx_dp.dtype == spec["dtype"]
    if spec["dtype"] == torch.bfloat16:
        for a, b in ((y_dp, y), (dx_dp, x.grad)):
            b = b.detach().float()
            torch.testing.assert_close(a.float(), b, rtol=0, atol=2.0 ** -8 * float(b.abs().max()))
        affine = dict(rtol=1e-3, atol=1e-4)
    else:
        torch.testing.assert_close(y_dp, y.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx_dp, x.grad, rtol=1e-5, atol=1e-5)
        affine = dict(rtol=1e-5, atol=1e-4)
    for g in got:
        torch.testing.assert_close(g["dweight"], ref.weight.grad, **affine)
        torch.testing.assert_close(g["dbias"], ref.bias.grad, **affine)
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(g["state"][k], getattr(ref, k), rtol=1e-5, atol=1e-6)
        assert int(g["state"]["num_batches_tracked"]) == 4
    _both_ranks_equal(got[0]["state"], got[1]["state"], name)


@pytest.mark.parametrize("name", ["gan", "dcgan", "wgan_gp"])
@pytest.mark.parametrize("against", ["jax_sharded", "port_single"])
def test_two_rank_step_matches(run, name, against):
    """One step (wgan_gp: a d_step and the g_step after it) on two ranks
    against the JAX step sharded over two devices, or the port's single
    process, from the same weights and draws."""
    payload, jax_out, single = run["refs"][name]
    want = jax_out if against == "jax_sharded" else single
    r0, r1 = (r[name] for r in run["ranks"])
    rtol = STEPS[name][3] if name in STEPS else 1e-4
    for k in ("d_loss", "g_loss"):
        assert float(r0[k]) == float(r1[k]), k
        np.testing.assert_allclose(float(r0[k]), float(want[k]), rtol=rtol, err_msg=k)
    gen = torch.cat([r0["gen_imgs"], r1["gen_imgs"]]).numpy()
    np.testing.assert_allclose(gen, np.asarray(want["gen_imgs"]), atol=1e-5)
    for role, sd in r0["state"].items():
        _held(sd, want["state"][role], r0["grads"][role], payload["cfg"].lr, f"{name} {role}",
              counts=against == "port_single")


@pytest.mark.parametrize("name", ["gan", "dcgan", "wgan_gp", "dcgan_own_draws"])
def test_ranks_hold_the_same_state_and_the_same_missing_gradients(run, name):
    """After the step both ranks hold the same parameters, buffers and
    averaged gradients bit for bit, and the parameters without a gradient
    (none of these steps leaves one) are the same set on both."""
    r0, r1 = (r[name] for r in run["ranks"])
    _both_ranks_equal(r0["state"], r1["state"], name)
    _both_ranks_equal(r0["grads"], r1["grads"], name)
    assert r0["none"] == r1["none"]


def test_default_draws_are_the_global_batch_s(run):
    """Without draws passed in, each rank draws z and the masks for the
    global batch from ``state.draws`` and keeps its rows: the ranks' images
    are the single process's halves, so the two ranks do not share a z."""
    r0, r1 = (r["dcgan_own_draws"] for r in run["ranks"])
    single = run["own_single"]
    gen = single["gen_imgs"]
    torch.testing.assert_close(r0["gen_imgs"], gen[:B // 2], rtol=0, atol=1e-5)
    torch.testing.assert_close(r1["gen_imgs"], gen[B // 2:], rtol=0, atol=1e-5)
    assert float((r0["gen_imgs"] - r1["gen_imgs"]).abs().max()) > 0.1
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(r0[k]), float(single[k]), rtol=2e-4, err_msg=k)
    lr = run["payload"]["dcgan_own_draws"]["cfg"].lr
    for role, sd in r0["state"].items():
        _held(sd, single["state"][role], r0["grads"][role], lr, f"own draws {role}")


@pytest.mark.parametrize("kind", ["device", "unpaired"])
def test_loader_shares_concatenate_to_the_single_process_batches(run, kind):
    spec = run["payload"]["loader"]
    if kind == "device":
        single = DeviceLoader([spec["images"], spec["labels"]], spec["batch"], CPU, seed=3,
                              prefetch=0)
    else:
        single = UnpairedLoader(spec["a"], spec["b"], spec["batch"], CPU, seed=4, prefetch=0,
                                host_transform=resize_crop_flip_transform(4, 16, 16))
    want = list(single.epoch(1))
    got = [r["loader"][kind] for r in run["ranks"]]
    assert got[0]["len"] == got[1]["len"] == len(single) == len(want)
    for j, batch in enumerate(want):
        for t, (a, b) in enumerate(zip(got[0]["epoch1"][j], got[1]["epoch1"][j])):
            assert a.shape[0] == b.shape[0] == spec["batch"] // 2
            assert torch.equal(torch.cat([a, b]), batch[t]), (kind, j, t)


def test_ragged_last_batch_is_dropped_with_the_jax_warning_under_dp(run):
    spec = run["payload"]["loader"]
    n, batch = spec["ragged_n"], spec["batch"]
    assert n % batch
    for r in run["ranks"]:
        ragged = r["loader"]["ragged"]
        assert ragged["drop_last"] and ragged["len"] == n // batch
        assert ragged["shapes"] == [(batch // 2, 16, 16, 1)] * (n // batch)
        assert any("incompatible with a sharded (data-parallel) batch" in w
                   for w in ragged["warnings"])


def test_gloo_refuses_fused_dispatch(run):
    for r in run["ranks"]:
        assert "needs NCCL" in r["fused_gloo"] and "gloo" in r["fused_gloo"]


def test_cli_writes_from_rank_zero_only_and_matches_one_process(run):
    """``dcgan.main`` on two ranks, each given its own output directory:
    rank 0's holds the grids and metrics, equal to one process's, and rank
    1's holds no file."""
    d0, d1 = (r["cli_dir"] for r in run["ranks"])
    single = run["single_dir"]
    assert [f for _, _, fs in os.walk(d1) for f in fs] == []
    names = sorted(os.listdir(os.path.join(single, "images")))
    assert names == ["0.png", "2.png"] == sorted(os.listdir(os.path.join(d0, "images")))
    for name in names:
        with open(os.path.join(d0, "images", name), "rb") as f:
            got = decode_png(f.read()).astype(int)
        with open(os.path.join(single, "images", name), "rb") as f:
            want = decode_png(f.read()).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1, name

    def rows(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = rows(d0), rows(single)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=f"step {g['step']} {k}")


def test_auto_sharding_warns_on_an_indivisible_batch_without_a_launcher(monkeypatch):
    """``tpugan/parallel/mesh.py:auto_sharding``'s warning, with the CUDA
    devices this process would see; without a launcher it is one process
    either way, and the CLI says how to launch one a device."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert auto_sharding(7, "cuda") is None
    assert any("SINGLE-DEVICE" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert auto_sharding(8, "cuda") is None
    assert not caught
    notice = one_device_notice(["dcgan", "--batch_size", "8"])
    assert "torchrun --nproc_per_node 2 -m tpugan_torch dcgan --batch_size 8" in notice
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert one_device_notice(["dcgan"]) == ""


def test_auto_sharding_raises_on_an_indivisible_batch_under_a_launcher(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="not divisible by the 2 data-parallel ranks"):
        auto_sharding(7, "cpu")


@pytest.mark.parametrize("mod, item", [(cgan, "9b"), (softmax_gan, "9c"), (pix2pix, "9d")])
def test_trainers_outside_the_slice_refuse_several_ranks(monkeypatch, tmp_path, mod, item):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        mod.main(["--synthetic_data", "--output_dir", str(tmp_path)], "cpu")


def test_dryrun_multichip_runs_on_two_cpu_ranks():
    got = dryrun_multichip(2, "cpu")
    assert got["backend"] == "gloo"
    assert np.isfinite(got["d_loss"]) and np.isfinite(got["g_loss"])
