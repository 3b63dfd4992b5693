"""The port's data-parallel CycleGAN on the CPU with two gloo ranks, against
the JAX step sharded over two devices and the port's single process, and its
CLI: checkpoints written by rank 0 alone and the ``--epoch`` resume on both
ranks.

The step runs at 64px with one residual block and a global batch of 4, from
the JAX package's initial weights, with both replay buffers full (50 seeded
images) so that every element of the batch draws a coin and an index. The
draws are read off the JAX step's key splits (``tpugan/models/cyclegan.py:130``,
``tpugan/train/replay.py:37-69``) and passed to every rank, which runs the
buffer on the gathered global fakes. One spawn of two rank processes
(``tests/_torch_dp_ranks.py:cyclegan``) runs the step and the CLI.

Tolerances, float32 with sums in different orders, those of
``tests/test_parallel.py`` and ``tests/test_torch_port_cyclegan.py``: the five
losses 1e-4 relative; parameters 1e-3 relative and 1e-5 absolute where the
gradient is above a noise floor, 2*lr below it (Adam's first step is
lr*g/(|g|+eps), which turns the rounding noise of a near-zero gradient into
+-lr: the conv biases that feed an instance norm, and some weights). The
floor is 1e-4 of the module's largest gradient. Against JAX, at this size
float32 rounding alone moves the gradient of each generator's first conv
(largest element 1.35) by 6.1e-4 in the port and 1.7e-3 in JAX from the
port's float64 gradient, the JAX single device and its 2-device step alike,
so a few elements above that floor have no sign either side can be held to.
There the 2-rank step may leave the tolerance only where the port's single
process leaves it against the JAX single-device step: data parallelism
adds no disagreement with JAX. The buffers 1e-5 absolute, and bit for bit
across the ranks. The CLI's checkpoints after two steps an epoch against one
process's: every element within ``chip_smoke.adam_envelope`` (how far two
runs of Adam can carry a parameter apart whatever their gradients: 4.1*lr
after two steps), and, apart from the conv biases that feed an
instance norm (their true gradient is 0), 99% of each tensor's elements
within 1e-3 relative and 1e-5 absolute; its PNGs within one level of 255.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_cyclegan import _feeds_instance_norm

import _torch_dp_ranks as ranks
from chip_smoke import adam_envelope
from tpugan.models import cyclegan as cg_j
from tpugan.parallel import batch_sharding, data_mesh, shard_state
from tpugan_torch.io.images import decode_png
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.models import cyclegan as cg_t
from tpugan_torch.train.replay import ReplayBuffer

CPU = torch.device("cpu")
H, B = 64, 4
CLI = ["--synthetic_data", "--img_height", "32", "--img_width", "32", "--n_residual_blocks", "1",
       "--batch_size", "2", "--max_batches", "2", "--n_epochs", "2", "--decay_epoch", "1",
       "--sample_interval", "4", "--checkpoint_interval", "1", "--log_interval", "1"]
RESUME = ["--epoch", "1"] + CLI
CLI_STEPS = 2  # an epoch


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _replay_draws(key, n):
    """The coins and indices ``replay_push_and_pop`` draws for a batch of
    ``n`` with the buffer full."""
    coins, idxs = [], []
    for k in jax.random.split(key, n):
        k_coin, k_idx = jax.random.split(k)
        coins.append(float(jax.random.uniform(k_coin)))
        idxs.append(int(jax.random.randint(k_idx, (), 0, 50)))
    return coins, idxs


def _port_step(cfg, spec):
    """The port's single process on the whole batch."""
    modules = cg_t.build(cfg, CPU)
    for name, sd in spec["init"].items():
        modules[name].load_state_dict(sd)
    state = cg_t.create_state(cfg, modules, CPU)
    for name, buf in state.buffers.items():
        buf.data.copy_(spec["buffers"][name])
        buf.count = buf.max_size
        coins, idxs = spec["draws"][name]
        buf.push_and_pop = (lambda b, _buf=buf, _c=coins, _i=idxs:
                            ReplayBuffer.push_and_pop(_buf, b, _c, _i))
    state, out = cg_t.make_step(cfg, modules, CPU)(state, spec["a"], spec["b"])
    return {"out": {k: float(v) for k, v in out.items()},
            "state": {n: m.state_dict() for n, m in modules.items()},
            "buffers": {n: b.data for n, b in state.buffers.items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg_j = cg_j.Config(img_height=H, img_width=H, n_residual_blocks=1, batch_size=B,
                        synthetic_data=True)
    cfg_t = cg_t.Config(img_height=H, img_width=H, n_residual_blocks=1, batch_size=B,
                        synthetic_data=True)
    modules = cg_j.build(cfg_j)
    state0 = cg_j.create_state(cfg_j, modules, steps_per_epoch=10)
    rng = np.random.default_rng(12)
    bufs = {n: rng.uniform(-1, 1, (50, H, H, 3)).astype(np.float32) for n in ("buf_A", "buf_B")}
    state0 = state0.replace(aux={n: {"data": jnp.asarray(d), "count": jnp.asarray(50, jnp.int32)}
                                 for n, d in bufs.items()})
    a = rng.integers(0, 256, (B, H, H, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (B, H, H, 3), dtype=np.uint8)
    mesh = data_mesh(jax.devices()[:2])
    step = jax.jit(cg_j.make_step(cfg_j, modules, steps_per_epoch=10))
    state1, out = step(shard_state(state0, mesh),
                       *(jax.device_put(x, batch_sharding(mesh)) for x in (a, b)))
    one_device = _np(step(state0, a, b)[0].params)
    _, k_a, k_b = jax.random.split(state0.rng, 3)
    params0 = _np(state0.params)
    init = {}
    for name in cg_t.MODULES:
        m = load_jax_params(cg_t.build(cfg_t, CPU)[name], params0[name])
        init[name] = {k: v.clone() for k, v in m.state_dict().items()}
    as_port = lambda tree: {n: {k: v.clone() for k, v in load_jax_params(
        cg_t.build(cfg_t, CPU)[n], tree[n]).state_dict().items()} for n in cg_t.MODULES}
    spec = {"cfg": cfg_t, "init": init, "a": torch.from_numpy(a), "b": torch.from_numpy(b),
            "buffers": {n: _nchw(d) for n, d in bufs.items()},
            "draws": {"buf_A": _replay_draws(k_a, B), "buf_B": _replay_draws(k_b, B)}}
    jax_ref = {"out": {k: float(v) for k, v in out.items()}, "state": as_port(_np(state1.params)),
               "one_device": as_port(one_device),
               "buffers": {n: _nchw(state1.aux[n]["data"]) for n in bufs}}
    work = str(tmp_path_factory.mktemp("dp_cyclegan"))
    got = ranks.spawn("cyclegan", {"step": spec, "cli": CLI, "resume": RESUME}, work)
    single_dir = os.path.join(work, "single")
    cg_t.main(CLI + ["--output_dir", single_dir], "cpu")
    return {"spec": spec, "jax": jax_ref, "single": _port_step(cfg_t, spec), "ranks": got,
            "single_dir": single_dir}


def test_the_full_buffers_swap(run):
    """The draws make the buffers both swap and keep: the case is not the
    filling one."""
    coins = [c for cs, _ in run["spec"]["draws"].values() for c in cs]
    assert any(c > 0.5 for c in coins) and any(c <= 0.5 for c in coins)


def _outside(got, want, grads, lr):
    """Per parameter, the elements of ``got`` outside the step tolerance of
    ``want`` (module docstring); ``grads`` set the noise floor."""
    noise = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    out = {}
    for k, w in want.items():
        bound = 1e-5 + 1e-3 * w.abs()
        bound = torch.where(grads[k].abs() <= noise, bound + 2 * lr, bound)
        out[k] = (got[k] - w).abs() > bound
    return out


@pytest.mark.parametrize("against", ["jax_sharded", "port_single"])
def test_two_rank_step_matches(run, against):
    want = run[{"jax_sharded": "jax", "port_single": "single"}[against]]
    r0, r1 = run["ranks"]
    for k, v in want["out"].items():
        assert float(r0["out"][k]) == float(r1["out"][k]), k
        np.testing.assert_allclose(float(r0["out"][k]), v, rtol=1e-4, err_msg=k)
    lr = run["spec"]["cfg"].lr
    for name, sd in r0["state"].items():
        grads = r0["grads"][name]
        off = _outside(sd, want["state"][name], grads, lr)
        if against == "jax_sharded":
            single_off = _outside(run["single"]["state"][name], run["jax"]["one_device"][name],
                                  grads, lr)
        for k, bad in off.items():
            assert float((sd[k] - want["state"][name][k]).abs().max()) <= 2 * lr + 1e-5, k
            if against == "jax_sharded":
                bad = bad & ~single_off[k]
            assert not bad.any(), f"{name} {k}: {int(bad.sum())} elements off"


@pytest.mark.parametrize("name", ["buf_A", "buf_B"])
def test_replay_buffers_are_identical_on_both_ranks_and_match(run, name):
    (d0, c0), (d1, c1) = (r["buffers"][name] for r in run["ranks"])
    assert c0 == c1 == 50
    assert torch.equal(d0, d1)
    torch.testing.assert_close(d0, run["jax"]["buffers"][name], rtol=0, atol=1e-5)
    torch.testing.assert_close(d0, run["single"]["buffers"][name], rtol=0, atol=1e-5)


def test_ranks_hold_the_same_modules_and_the_same_missing_gradients(run):
    r0, r1 = run["ranks"]
    for name in cg_t.MODULES:
        for k, v in r0["state"][name].items():
            assert torch.equal(v, r1["state"][name][k]), f"{name} {k}"
        for k, g in r0["grads"][name].items():
            assert torch.equal(g, r1["grads"][name][k]), f"{name} {k}"
    assert r0["none"] == r1["none"] == {n: [] for n in cg_t.MODULES}


def test_cli_checkpoints_and_samples_come_from_rank_zero_alone(run):
    d0, d1 = (r["cli_dir"] for r in run["ranks"])
    assert [f for _, _, fs in os.walk(d1) for f in fs] == []
    ckpt = lambda d: os.path.join(d, "saved_models", "monet2photo")
    files = sorted(os.listdir(ckpt(run["single_dir"])))
    assert files == sorted(f"{n}_{e}.pth" for n in cg_t.MODULES for e in (0, 1))
    assert sorted(os.listdir(ckpt(d0))) == files
    for f in files:
        if not f.endswith("_0.pth"):
            continue  # the resume run rewrote rank 0's epoch-1 files
        got = torch.load(os.path.join(ckpt(d0), f), weights_only=True)
        want = torch.load(os.path.join(ckpt(run["single_dir"]), f), weights_only=True)
        assert list(got) == list(want)
        cfg = run["spec"]["cfg"]
        envelope = adam_envelope(cfg.lr, cfg.b1, cfg.b2, CLI_STEPS) + 1e-6
        module = cg_t.build(run["spec"]["cfg"], CPU)[f.rsplit("_", 1)[0]]
        for k, w in want.items():
            diff = (got[k] - w).abs()
            assert float(diff.max()) <= envelope, f"{f} {k}"
            if _feeds_instance_norm(module, k):
                continue
            close = diff <= 1e-5 + 1e-3 * w.abs()
            assert float(close.float().mean()) >= 0.99, f"{f} {k}"
    imgs = lambda d: os.path.join(d, "images", "monet2photo")
    names = sorted(os.listdir(imgs(run["single_dir"])))
    assert names == ["0.png"] == sorted(os.listdir(imgs(d0)))
    for name in names:
        with open(os.path.join(imgs(d0), name), "rb") as f:
            got = decode_png(f.read()).astype(int)
        with open(os.path.join(imgs(run["single_dir"]), name), "rb") as f:
            want = decode_png(f.read()).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1, name


def test_epoch_resume_loads_rank_zero_s_checkpoints_on_both_ranks(run):
    """``--epoch 1`` on both ranks reads the epoch-1 files rank 0 wrote:
    each rank loads the modules the first run ended with, bit for bit."""
    r0, r1 = run["ranks"]
    assert sorted(r0["resumed"]) == sorted(cg_t.MODULES)
    for name in cg_t.MODULES:
        for k, v in r0["cli_final"][name].items():
            assert torch.equal(r0["resumed"][name][k], v), f"{name} {k}"
            assert torch.equal(r1["resumed"][name][k], v), f"{name} {k}"
