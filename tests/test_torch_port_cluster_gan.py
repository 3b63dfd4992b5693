"""The port's cluster_gan against the JAX package on the CPU at 28px (the
generator's 7x7 start fixes it), batch 8, latent 16.

One ``full_step`` and one ``d_step`` in each ``--wass_flag`` branch go
against one ``jax.jit`` of the JAX step from the same weights, with the
harness of ``tests/test_torch_port_critic_rest.py``: the JAX step's zn,
class draws and penalty alpha read off its own key splits and passed in;
the gradients each optimizer applies recorded on both sides ("ge" over the
generator and the encoder, with weight decay 2.5e-5 added after the
gradient, and D's). Tolerances are that file's: losses 1e-5 relative,
images 1e-5 absolute, gradients 1e-3 relative plus 1e-4 of the module's
largest, each update Adam's first step of the port's own gradient (1e-6
relative, 1e-7 absolute) and within 1e-5 of JAX's where settled, running
statistics 1e-4 relative and 1e-6 absolute. The penalty with ``norm_eps``:
the value 1e-5 relative, parameter gradients as above. The epoch-end
evaluation's image cycle loss, which draws nothing: 1e-5 relative (printed
to six places, both sides).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import (
    CPU,
    Spec,
    _assert_grads_close,
    _grads_as_port,
    _recording,
    as_port,
    check_gradients,
    check_losses_and_images,
    check_params,
    check_running_stats,
    nchw,
    np_tree,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    png_size,
    port_modules,
    record_updates,
    run_main,
    t,
)

from tpugan.models import cluster_gan as cg_j
from tpugan.models._common import apply_mod
from tpugan.ops.penalty import wgan_gp_penalty as wgan_gp_penalty_j
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import cluster_gan as cg_t
from tpugan_torch.ops.penalty import wgan_gp_penalty

B, LATENT, SIZE = 8, 16, 28
SPEC = Spec(cg_j, cg_t, None, {"generator": 1})


def _draws(rng, cfg):
    """``tpugan/models/cluster_gan.py:234-235,76-86``: zn (scaled), the
    classes, the penalty's alpha."""
    _, k_z, k_gp = jax.random.split(rng, 3)
    k_zn, k_zc = jax.random.split(k_z)
    return {"zn": t(0.75 * jax.random.normal(k_zn, (B, cfg.latent_dim))),
            "zc_idx": t(jax.random.randint(k_zc, (B,), 0, cg_j.N_C), np.int64),
            "alpha": t(jax.random.uniform(k_gp, (B, 1, 1, 1), jnp.float32))}


def _cfgs(wass):
    kw = dict(batch_size=B, latent_dim=LATENT, img_size=SIZE, synthetic_data=True,
              wass_flag=wass)
    return cg_j.Config(**kw), cg_t.Config(**kw)


@functools.lru_cache(maxsize=None)
def ref_of(wass, kind):
    """One ``kind`` step ("full" or "d") of each framework from the same
    weights, batch and draws, in the harness's ref layout."""
    cfg_j, cfg_t = _cfgs(wass)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (B, SIZE, SIZE, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, B).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cg_j, "adam_torch", _recording(cg_j.adam_torch))
        mods = cg_j.build(cfg_j)
        state0 = cg_j.create_state(cfg_j, mods)
        full_j, d_j = cg_j.make_steps(cfg_j, mods)
        state1, out = jax.jit(full_j if kind == "full" else d_j)(state0, imgs, labels)
    params0, stats0 = np_tree(state0.params), np_tree(state0.model_state)
    kw = _draws(state0.rng, cfg_j)
    if not wass:
        del kw["alpha"]
    modules = port_modules(SPEC, cfg_t, params0, stats0)
    state = cg_t.create_state(cfg_t, modules, CPU)
    rec = record_updates(state)
    full_t, d_t = cg_t.make_steps(cfg_t, state)
    before = {r: {k: v.clone() for k, v in m.state_dict().items()} for r, m in modules.items()}
    state, out_t = (full_t if kind == "full" else d_t)(state, t(imgs), t(labels), **kw)
    grads_j = {}
    for name, st in np_tree(state1.opt_state).items():
        if name not in rec:
            continue
        trees = st["g"] if set(st["g"]) <= set(mods) else {name: st["g"]}
        for role, tree in trees.items():
            grads_j.setdefault(name, {})[role] = as_port(SPEC, cfg_t, role, tree, stats0)
    return {
        "spec": SPEC, "cfg_t": cfg_t, "mods": mods, "state": state, "rec": rec,
        "params0": params0, "stats0": stats0, "out": {k: np.asarray(v) for k, v in out.items()},
        "params1": np_tree(state1.params), "stats1": np_tree(state1.model_state),
        "grads_j": grads_j, "out_t": out_t, "modules": modules, "before": before,
        "weight_decay": {"ge": cg_t.DECAY}, "kind": kind,
        "exempt": () if kind == "full" else ("generator", "encoder"),
    }


CASES = [(wass, kind) for wass in (False, True) for kind in ("full", "d")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[1]}_step-wass{int(c[0])}")
def ref(request):
    return ref_of(*request.param)


def test_step_losses_and_images_match_jax(ref):
    keys = ("d_loss", "ge_loss") if ref["kind"] == "full" else ("d_loss",)
    check_losses_and_images(ref, keys)
    assert sorted(ref["out_t"]) == sorted(ref["out"])


def test_step_gradients_match_jax(ref):
    """full_step: "ge" over G and E, then D's; d_step: D's alone."""
    check_gradients(ref)
    want = {"ge", "discriminator"} if ref["kind"] == "full" else {"discriminator"}
    assert set(ref["rec"]) == want
    if ref["kind"] == "full":
        assert {r for r, _ in ref["rec"]["ge"][0]} == {"generator", "encoder"}


def test_step_params_match_jax(ref):
    """Adam's first step with "ge"'s weight decay; the d_step leaves G's and
    E's parameters as they were."""
    check_params(ref)
    if ref["kind"] == "d":
        for role in ("generator", "encoder"):
            for k, p in ref["modules"][role].named_parameters():
                assert torch.equal(p, ref["before"][role][k]), (role, k)


def test_step_running_stats_match_jax(ref):
    """G's BatchNorms after their one forward, in both steps (the d_step's
    G runs in training mode); E and D have none."""
    check_running_stats(ref)


def test_wass_and_bce_branches_differ_in_d_only_by_their_losses():
    """From the same weights and draws the two branches' D gradients differ,
    and the BCE branch's D ends in a Sigmoid that the Wasserstein one has
    not."""
    a, b = ref_of(False, "d"), ref_of(True, "d")
    ga, gb = ([g for _, g, _ in r["rec"]["discriminator"][0].values()] for r in (a, b))
    assert len(ga) == len(gb) and any(not torch.equal(x, y) for x, y in zip(ga, gb))
    assert isinstance(a["modules"]["discriminator"].model[-1], torch.nn.Sigmoid)
    assert not isinstance(b["modules"]["discriminator"].model[-1], torch.nn.Sigmoid)


def test_steps_draw_from_the_state_generator_in_the_documented_order():
    """zn (0.75 * N(0, 1)), the classes, then (``--wass_flag``) alpha, from
    ``state.draws``; the one-hot is the classes'."""
    for wass in (False, True):
        cfg = _cfgs(wass)[1]
        state = cg_t.create_state(cfg, cg_t.build(cfg, CPU), CPU)
        g = torch.Generator().manual_seed(cfg.seed)
        zn = 0.75 * torch.randn(B, LATENT, generator=g)
        idx = torch.randint(0, cg_t.N_C, (B,), generator=g)
        if wass:
            torch.rand(B, 1, 1, 1, generator=g)
        seen = []
        forward = state.modules["generator"].forward
        state.modules["generator"].forward = lambda a, b: seen.append((a, b)) or forward(a, b)
        _, d_step = cg_t.make_steps(cfg, state)
        d_step(state, torch.zeros(B, SIZE, SIZE, 1, dtype=torch.uint8))
        assert torch.equal(state.draws.get_state(), g.get_state())
        assert torch.equal(seen[0][0], zn)
        assert torch.equal(seen[0][1], torch.nn.functional.one_hot(idx, cg_t.N_C).float())


def test_penalty_with_norm_eps_matches_jax_on_the_critic():
    """``wgan_gp_penalty(norm_eps=1e-12)`` and its parameter gradients on
    cluster_gan's Wasserstein critic, alpha from the JAX penalty's key."""
    cfg_j, cfg_t = _cfgs(True)
    D_j = cg_j.build(cfg_j)["discriminator"]
    rng = np.random.default_rng(3)
    real, fake = (rng.uniform(0, 1, (B, SIZE, SIZE, 1)).astype(np.float32) for _ in range(2))
    params = D_j.init(jax.random.PRNGKey(1), jnp.asarray(real))["params"]
    key = jax.random.PRNGKey(4)

    def penalty(p):
        return wgan_gp_penalty_j(lambda x: apply_mod(D_j, p, None, x)[0], jnp.asarray(real),
                                 jnp.asarray(fake), key, norm_eps=1e-12)  # cluster_gan.py:204

    gp_j, grads_j = jax.value_and_grad(penalty)(params)
    alpha = t(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    D = cg_t.build(cfg_t, CPU)["discriminator"]
    load_jax_params(D, np_tree(params))
    gp = wgan_gp_penalty(D, t(nchw(real)), t(nchw(fake)), alpha, norm_eps=cg_t.GP_NORM_EPS)
    gp.backward()
    assert cg_t.GP_NORM_EPS == 1e-12
    np.testing.assert_allclose(float(gp.detach()), float(gp_j), rtol=1e-5)
    want = _grads_as_port(D, cg_t.build(cfg_t, CPU)["discriminator"], grads_j, {})
    _assert_grads_close(D, want)


def test_penalty_norm_eps_sits_inside_the_square_root():
    """An identity-like critic with dD/dx = 0: the norm is sqrt(eps), not 0
    (``_safe_sqrt``'s), and the gradient stays finite."""
    real = torch.zeros(2, 1, 2, 2)
    flat = lambda x: (0.0 * x).sum(dim=(1, 2, 3))
    alpha = torch.full((2, 1, 1, 1), 0.5)
    assert float(wgan_gp_penalty(flat, real, real, alpha)) == 1.0
    got = float(wgan_gp_penalty(flat, real, real, alpha, norm_eps=1e-4))
    assert got == pytest.approx((1e-2 - 1.0) ** 2, rel=1e-6)


# --- The epoch-end evaluation -----------------------------------------------------------


def test_epoch_end_cycle_loss_matches_jax_and_leaves_the_state_alone(tmp_path, capsys):
    """From the weights and running statistics after JAX's full_step: the
    image cycle loss, which draws nothing (E, then G in eval mode, on the
    evaluation set's first batch), equals JAX's to the printed six places;
    the three sheets by name and grid size; ``state.draws``, G's running
    statistics and its training mode as they were, and a second call
    writes the same PNGs."""
    r = ref_of(False, "full")
    cfg_j, cfg_t = _cfgs(False)
    cfg_j = dataclasses.replace(cfg_j, output_dir=str(tmp_path / "jax"))
    cfg_t = dataclasses.replace(cfg_t, output_dir=str(tmp_path / "port"))
    state1 = cg_j.create_state(cfg_j, r["mods"])
    state1 = state1.replace(params=jax.tree_util.tree_map(jnp.asarray, r["params1"]),
                            model_state=jax.tree_util.tree_map(jnp.asarray, r["stats1"]))
    cg_j.make_epoch_eval(cfg_j, r["mods"])(state1, 0)
    line_j = capsys.readouterr().out.strip()
    modules = port_modules(SPEC, cfg_t, r["params1"], r["stats1"])
    state = cg_t.create_state(cfg_t, modules, CPU)
    G = modules["generator"]
    draws = state.draws.get_state()
    stats = {k: v.clone() for k, v in G.state_dict().items()}
    epoch_end = cg_t.make_epoch_eval(cfg_t, CPU)
    pngs = []
    for _ in range(2):
        epoch_end(state, 0)
        imgdir = tmp_path / "port" / "images"
        pngs.append({f: (imgdir / f).read_bytes() for f in sorted(os.listdir(imgdir))})
    line_t = capsys.readouterr().out.strip().splitlines()[0]
    x = lambda line: float(line.split("[x: ")[1].split("]")[0])
    np.testing.assert_allclose(x(line_t), x(line_j), rtol=1e-5)
    assert line_t.startswith("Cycle Losses: [x: ") and "[z_n: " in line_t and "[z_c: " in line_t
    assert pngs[0] == pngs[1]
    assert sorted(pngs[0]) == sorted(os.listdir(tmp_path / "jax" / "images")) == [
        "cycle_reg_000000.png", "gen_000000.png", "gen_classes_000000.png"]
    cell = SIZE + 2
    assert png_size(pngs[0]["cycle_reg_000000.png"]) == (5 * cell + 2, 2 * cell + 2)
    assert png_size(pngs[0]["gen_000000.png"]) == (5 * cell + 2,) * 2
    assert png_size(pngs[0]["gen_classes_000000.png"]) == (10 * cell + 2,) * 2
    assert torch.equal(state.draws.get_state(), draws) and G.training
    assert all(torch.equal(v, G.state_dict()[k]) for k, v in stats.items())


# --- Modules, flags, mains -------------------------------------------------------------


def test_state_dict_keys_are_the_reference_layout():
    """clustergan.py:143-297: the generator's ``model`` (Reshape at 6),
    the encoder's and the Wasserstein critic's (Reshape at 4), and the BCE
    critic's ``nn.Sequential(model, Sigmoid())``; every Conv,
    ConvTranspose and Linear N(0, 0.02) with zero bias, the BatchNorms
    torch's."""
    wb = lambda p: [f"{p}.weight", f"{p}.bias"]
    bn = lambda p: wb(p) + [f"{p}.running_mean", f"{p}.running_var", f"{p}.num_batches_tracked"]
    stack = lambda p: wb(f"{p}.0") + wb(f"{p}.2") + wb(f"{p}.5") + wb(f"{p}.7")
    want = {"generator": wb("model.0") + bn("model.1") + wb("model.3") + bn("model.4")
            + wb("model.7") + bn("model.8") + wb("model.10"),
            "encoder": stack("model"), "discriminator": stack("model")}
    for wass in (True, False):
        modules = cg_t.build(cg_t.Config(wass_flag=wass), CPU)
        got = {r: list(m.state_dict()) for r, m in modules.items()}
        if not wass:
            want["discriminator"] = stack("model.0")
        assert got == want, wass
        for m in modules.values():
            for layer in m.modules():
                if isinstance(layer, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                    assert not layer.bias.detach().any()
                    assert float(layer.weight.detach().std()) < 0.03
                if isinstance(layer, torch.nn.modules.batchnorm._BatchNorm):
                    assert torch.equal(layer.weight, torch.ones_like(layer.weight))
    assert modules["encoder"].model[5].in_features == 128 * 5 * 5


def test_optimizers_are_the_reference_ones():
    """"ge": one Adam over G's and then E's parameters, each once, betas
    (0.5, 0.9), weight decay 2.5e-5; D's with the same betas, no decay."""
    cfg = cg_t.Config()
    modules = cg_t.build(cfg, CPU)
    state = cg_t.create_state(cfg, modules, CPU)
    ge, d = state.optimizers["ge"], state.optimizers["discriminator"]
    params = [p for g in ge.param_groups for p in g["params"]]
    want = list(modules["generator"].parameters()) + list(modules["encoder"].parameters())
    assert [id(p) for p in params] == [id(p) for p in want]
    assert ge.defaults["betas"] == d.defaults["betas"] == (0.5, 0.9)
    assert (ge.defaults["weight_decay"], d.defaults["weight_decay"]) == (2.5e-5, 0)
    assert ge.defaults["lr"] == d.defaults["lr"] == 1e-4


def test_config_flags_match_jax():
    got = {f.name: (f.default, f.type, f.metadata.get("short"))
           for f in dataclasses.fields(cg_t.Config)}
    want = {f.name: (f.default, f.type, f.metadata.get("short"))
            for f in dataclasses.fields(cg_j.Config)}
    assert got == want


MAIN_ARGV = ["--synthetic_data", "--n_epochs", "2", "--max_batches", "5", "--batch_size", "8",
             "--latent_dim", str(LATENT), "--n_critic", "2"]


@pytest.mark.parametrize("wass", [False, True], ids=["bce", "wass"])
def test_a_five_batch_main_writes_the_rows_and_sheets_of_jax(tmp_path, wass, capsys):
    """Two epochs of five batches, n_critic 2: the same metric rows' steps
    and keys (ge_loss on batches 0, 2 and 4), the same epoch lines and the
    same three sheets an epoch as the JAX trainer's main; the port's losses
    finite."""
    argv = MAIN_ARGV + (["--wass_flag"] if wass else [])
    got = {}
    for side, main in (("jax", cg_j.main), ("port", lambda a: cg_t.main(a, CPU))):
        (tmp_path / side).mkdir()  # the metrics file opens before the loop makes images/
        _, rows, pngs = run_main(main, argv, tmp_path / side)
        out = capsys.readouterr().out.splitlines()
        lines = [ln.split("] \n")[0] for ln in out if ln.startswith(("[Epoch", "\tCycle"))]
        got[side] = ([(r["step"], sorted(r)) for r in rows], [ln[:12] for ln in lines],
                     sorted(pngs))
        if side == "port":
            assert all(np.isfinite([v for k, v in r.items() if k != "step"]).all() for r in rows)
    assert got["port"] == got["jax"]
    assert [s for s, keys in got["port"][0] if "ge_loss" in keys] == [0, 2, 4, 5, 7, 9]
    assert got["port"][2] == sorted(f"{n}_{e:06d}.png" for n in ("cycle_reg", "gen",
                                                                  "gen_classes")
                                    for e in range(2))


def test_steps_per_dispatch_prints_the_notice_and_runs_per_step(tmp_path, capsys):
    """The trainer's own loop does not fuse, as the JAX package's: the
    notice, then the unfused run's rows bit for bit."""
    runs = {}
    for k in (1, 3):
        (tmp_path / str(k)).mkdir()
        _, rows, pngs = run_main(lambda a: cg_t.main(a, CPU),
                                 MAIN_ARGV + ["--steps_per_dispatch", str(k)], tmp_path / str(k))
        out = capsys.readouterr().out
        assert ("--steps_per_dispatch is not supported" in out) == (k > 1)
        runs[k] = (rows, pngs)
    assert runs[3] == runs[1]


def test_run_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cg_t.main(["--synthetic_data", "--output_dir", str(tmp_path)])
