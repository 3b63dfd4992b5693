"""Rank processes of the port's data-parallel CPU tests
(``tests/test_torch_port_parallel*.py``).

``spawn(case, payload, work_dir)`` starts two processes of this file, each
with the environment ``torchrun`` gives a rank (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and one intra-op thread,
and returns what each rank's ``CASES[case](payload, work_dir)`` returned.
The first collective the case reaches through the port (``auto_sharding``
inside a trainer's ``run``) initializes the gloo group from that
environment, as under a launcher. Imports no JAX: the tests compute the JAX
side and pass its draws in ``payload``.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 600
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def spawn(name: str, payload: dict, work_dir: str, world: int = WORLD) -> list:
    """Run case ``name`` on ``world`` ranks; the ranks' results in rank
    order. Raises with every rank's output if one fails."""
    from tpugan_torch.parallel.dryrun import free_port

    os.makedirs(work_dir, exist_ok=True)
    torch.save(payload, os.path.join(work_dir, "payload.pt"))
    env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), name, work_dir],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=work_dir,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(f"--- rank {r} (exit {p.returncode}):\n{log}"
                                       for r, (p, log) in enumerate(zip(procs, logs))))
    got = []
    for name in [f"rank{r}.pt" for r in range(world)] + ["payload.pt"]:
        path = os.path.join(work_dir, name)
        if name != "payload.pt":
            got.append(torch.load(path, weights_only=False))
        os.remove(path)  # up to a GiB each at full width
    return got


def _dp():
    from tpugan_torch.parallel.mesh import auto_sharding

    return auto_sharding(WORLD * 4, "cpu")


def _grads_none(modules: dict) -> dict:
    return {role: sorted(k for k, p in m.named_parameters() if p.grad is None)
            for role, m in modules.items()}


def _sd(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _grads(module) -> dict:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters() if p.grad is not None}


def bn_case(dp, spec: dict) -> dict:
    """One global BatchNorm forward and backward on this rank's rows of
    ``spec["x"]``, loss sum(y * gy); the affine gradients summed over the
    ranks (the loss is a sum, not a mean)."""
    import torch.distributed as dist

    from tpugan_torch.nn.layers import BatchNorm1d, BatchNorm2d
    from tpugan_torch.parallel.mesh import local_rows

    x = spec["x"]
    bn = (BatchNorm1d if x.dim() == 2 else BatchNorm2d)(x.shape[1], spec["eps"])
    bn.load_state_dict(spec["state"])
    bn.dp = dp
    xl = local_rows(dp, x).to(spec["dtype"]).requires_grad_(True)
    y = bn(xl)
    (y.float() * local_rows(dp, spec["gy"])).sum().backward()
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    dist.all_reduce(dw)
    dist.all_reduce(db)
    return {"y": y.detach(), "dx": xl.grad, "dweight": dw, "dbias": db, "state": _sd(bn)}


def _template_b_step(mod, payload_case, dp):
    cfg = payload_case["cfg"]
    modules = mod.build(cfg, "cpu")
    for role, sd in payload_case["init"].items():
        modules[role].load_state_dict(sd)
    from tpugan_torch.parallel.mesh import local_rows, replicate_for

    state = replicate_for(dp, mod.create_state(cfg, modules, "cpu"))
    step = mod.make_step(cfg, state)
    kw = {}
    if "z" in payload_case:
        kw["z"] = payload_case["z"]
    if payload_case.get("masks") is not None:
        kw["masks"] = payload_case["masks"]
    state, out = step(state, local_rows(dp, payload_case["imgs"]), None, **kw)
    return {"d_loss": out["d_loss"], "g_loss": out["g_loss"], "gen_imgs": out["gen_imgs"],
            "state": {r: _sd(m) for r, m in modules.items()},
            "grads": {r: _grads(m) for r, m in modules.items()},
            "none": _grads_none(modules)}


def _wgan_gp_steps(payload_case, dp):
    from tpugan_torch.models import wgan_gp
    from tpugan_torch.parallel.mesh import local_rows, replicate_for

    cfg = payload_case["cfg"]
    modules = wgan_gp.build(cfg, "cpu")
    for role, sd in payload_case["init"].items():
        modules[role].load_state_dict(sd)
    state = replicate_for(dp, wgan_gp.create_state(cfg, modules, "cpu"))
    d_step, g_step = wgan_gp.make_steps(cfg, state)
    state, d_out = d_step(state, local_rows(dp, payload_case["imgs"]), None,
                          z=payload_case["z"], alpha=payload_case["alpha"])
    d_none = _grads_none(modules)
    state, g_out = g_step(state, d_out["z"])
    return {"d_loss": d_out["d_loss"], "g_loss": g_out["g_loss"], "gen_imgs": g_out["gen_imgs"],
            "state": {r: _sd(m) for r, m in modules.items()},
            "grads": {r: _grads(m) for r, m in modules.items()},
            "none": {"d_step": d_none, "g_step": _grads_none(modules)}}


def _loader_shares(spec, dp) -> dict:
    from tpugan_torch.data import loader as L
    from tpugan_torch.data.im2im import resize_crop_flip_transform

    out = {}
    for name, make in (
        ("device", lambda dp_: L.DeviceLoader([spec["images"], spec["labels"]], spec["batch"],
                                              "cpu", seed=3, prefetch=0, dp=dp_)),
        ("unpaired", lambda dp_: L.UnpairedLoader(
            spec["a"], spec["b"], spec["batch"], "cpu", seed=4, prefetch=2, dp=dp_,
            host_transform=resize_crop_flip_transform(4, 16, 16))),
    ):
        loader = make(dp)
        out[name] = {"len": len(loader),
                     "epoch1": [tuple(t.clone() for t in b) for b in loader.epoch(1)]}
    L.set_drop_last(False)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ragged = L.DeviceLoader([spec["images"][:spec["ragged_n"]]], spec["batch"], "cpu",
                                    seed=3, prefetch=0, dp=dp)
        out["ragged"] = {"len": len(ragged), "drop_last": ragged.drop_last,
                         "warnings": [str(w.message) for w in caught],
                         "shapes": [tuple(b[0].shape) for b in ragged.epoch(0)]}
    finally:
        L.set_drop_last(True)
    return out


def _refusal(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


@case
def units(payload: dict, work_dir: str) -> dict:
    """The global BatchNorm cases, one step of gan and dcgan and a d_step +
    g_step of wgan_gp from the JAX draws, dcgan's step with its own draws,
    the loaders' shares, gloo's refusal of fused dispatch and a 2-rank
    ``dcgan.main``."""
    from tpugan_torch.models import dcgan, gan

    dp = _dp()
    res = {"bn": {name: bn_case(dp, spec) for name, spec in payload["bn"].items()},
           "gan": _template_b_step(gan, payload["gan"], dp),
           "dcgan": _template_b_step(dcgan, payload["dcgan"], dp),
           "dcgan_own_draws": _template_b_step(dcgan, payload["dcgan_own_draws"], dp),
           "wgan_gp": _wgan_gp_steps(payload["wgan_gp"], dp),
           "loader": _loader_shares(payload["loader"], dp),
           "fused_gloo": _refusal(lambda: dcgan.main(
               payload["cli"] + ["--steps_per_dispatch", "2", "--output_dir",
                                 os.path.join(work_dir, "fused")], "cpu"))}
    rank_dir = os.path.join(work_dir, "rank%d" % dp.rank)
    os.makedirs(rank_dir)
    dcgan.main(payload["cli"] + ["--output_dir", rank_dir,
                                 "--metrics_jsonl", os.path.join(rank_dir, "metrics.jsonl")],
               "cpu")
    res["cli_dir"] = rank_dir
    return res


@case
def cyclegan(payload: dict, work_dir: str) -> dict:
    """One CycleGAN step from the JAX weights with full replay buffers and
    the JAX swap draws, then the 2-rank ``cyclegan.main`` with checkpoints
    and its ``--epoch`` resume."""
    from tpugan_torch.models import cyclegan as cg
    from tpugan_torch.parallel.mesh import local_rows, replicate_for
    from tpugan_torch.train.replay import ReplayBuffer

    spec = payload["step"]
    cfg = spec["cfg"]
    dp = _dp()
    modules = cg.build(cfg, "cpu")
    for name, sd in spec["init"].items():
        modules[name].load_state_dict(sd)
    state = replicate_for(dp, cg.create_state(cfg, modules, "cpu"))
    for name, buf in state.buffers.items():
        buf.data.copy_(spec["buffers"][name])
        buf.count = buf.max_size
        coins, idxs = spec["draws"][name]
        buf.push_and_pop = (lambda b, _buf=buf, _c=coins, _i=idxs:
                            ReplayBuffer.push_and_pop(_buf, b, _c, _i))
    step = cg.make_step(cfg, modules, "cpu")
    state, out = step(state, local_rows(dp, spec["a"]), local_rows(dp, spec["b"]))
    res = {"out": dict(out), "state": {n: _sd(m) for n, m in modules.items()},
           "grads": {n: _grads(m) for n, m in modules.items()},
           "none": _grads_none(modules),
           "buffers": {n: (b.data.clone(), b.count) for n, b in state.buffers.items()}}

    # The CLI: each rank its own output directory, then the resume from
    # rank 0's checkpoints on both ranks.
    rank_dir = os.path.join(work_dir, "rank%d" % dp.rank)
    os.makedirs(rank_dir)
    final = cg.main(payload["cli"] + ["--output_dir", rank_dir], "cpu")
    res["cli_dir"] = rank_dir
    res["cli_final"] = {n: _sd(m) for n, m in final.modules.items()}
    loaded = {}
    real_resume = cg.maybe_resume

    def recording_resume(mods, cfg_, names):
        real_resume(mods, cfg_, names)
        loaded.update({n: _sd(mods[n]) for n in names})

    cg.maybe_resume = recording_resume
    try:
        cg.main(payload["resume"] + ["--output_dir", os.path.join(work_dir, "rank0")], "cpu")
    finally:
        cg.maybe_resume = real_resume
    res["resumed"] = loaded
    return res


# --- The im2im, style and SR trainers ----------------------------------------------------------


def digest(t: torch.Tensor) -> str:
    """A tensor's dtype, shape and bytes, hashed: rank 1 reports these, and
    the test holds them to rank 0's tensors bit for bit."""
    import hashlib

    t = t.detach().contiguous().cpu()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return f"{t.dtype}{tuple(t.shape)}" + hashlib.sha1(raw).hexdigest()


def digests(tree):
    if isinstance(tree, dict):
        return {k: digests(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [digests(v) for v in tree]
    return digest(tree) if isinstance(tree, torch.Tensor) else tree


def record_grads(named: dict, optimizers: dict) -> dict:
    """Wrap each optimizer's ``step``: for each call, each of its parameters'
    (gradient or None, value after), by (role, key) of ``named``
    (``tests/test_torch_port_critic_rest.py:record_updates`` without the
    value before, which the test holds)."""
    names = {id(p): (role, k) for role, m in named.items() for k, p in m.named_parameters()}
    rec = {}
    for name, opt in optimizers.items():
        params = [p for g in opt.param_groups for p in g["params"]]

        def step(*a, _name=name, _params=params, _orig=opt.step, **kw):
            result = _orig(*a, **kw)
            rec.setdefault(_name, []).append(
                {names[id(p)]: (None if p.grad is None else p.grad.detach().clone(),
                                p.detach().clone()) for p in _params})
            return result

        opt.step = step
    return rec


class Decisions:
    """JAX's activation decisions, in call order, for this rank's rows
    (``tests/test_torch_port_unet_im2im.py:Decisions``, whose pre-activations
    arrive here NCHW and global): within ``patched``, each LeakyReLU and ReLU
    of the modules applies the next (pre-activation >= 0 for a LeakyReLU,
    > 0 for a ReLU). ``worst`` is the largest |pre-activation| of the
    port's own, relative to its layer's largest, at which its decision
    differs from JAX's."""

    def __init__(self, pre, dp):
        self.pre, self.dp, self.worst = iter(pre), dp, 0.0

    @contextlib.contextmanager
    def patched(self, modules):
        from tpugan_torch.nn.layers import LeakyReLU

        layers = [(layer, layer.negative_slope if isinstance(layer, LeakyReLU) else 0.0)
                  for m in modules for layer in m.modules()
                  if isinstance(layer, (LeakyReLU, torch.nn.ReLU))]
        for layer, slope in layers:
            layer.forward = self._forward(slope)
        try:
            yield
        finally:
            for layer, _ in layers:
                del layer.forward

    def _forward(self, slope):
        from tpugan_torch.parallel.mesh import local_rows

        def forward(x):
            z = local_rows(self.dp, next(self.pre)).to(x.dtype)
            keep = z >= 0 if slope else z > 0
            own = x >= 0 if slope else x > 0
            differ = keep != own
            if differ.any():
                mag = x.detach().abs()
                self.worst = max(self.worst, float(mag[differ].max() / mag.max()))
            return torch.where(keep, x, slope * x)

        return forward


def _run_plain(mod, cfg, state, batch, spec, dp):
    step = (mod.make_step(cfg, state.modules, "cpu") if mod.NAME == "munit"
            else mod.make_step(cfg, state))
    return step(state, *batch, **spec.get("draws", {}))[1], {}


def _run_dualgan(mod, cfg, state, batch, spec, dp):
    """``tests/test_torch_port_unet_im2im.py:_dualgan`` on this rank's rows:
    the d_step with JAX's fakes, masks, alphas and critic decisions; JAX's
    critics after it; the g_step with JAX's masks and decisions."""
    from tpugan_torch.parallel.mesh import local_rows

    d_step, g_step = mod.make_steps(cfg, state)
    m = state.modules
    fakes = iter([local_rows(dp, f) for f in spec["fakes"]])  # G_BA(b), then G_AB(a)
    d_decisions = Decisions(spec["d_pre"], dp)
    for role in ("G_BA", "G_AB"):
        m[role].forward = lambda *args, **kw: next(fakes)
    try:
        with d_decisions.patched([m["D_A"], m["D_B"]]):
            state, d_out = d_step(state, *batch, masks=spec["masks"][:2],
                                  alphas=spec["alphas"])
    finally:
        for role in ("G_BA", "G_AB"):
            del m[role].forward
    seen = {role: _sd(m[role]) for role in ("D_A", "D_B")}
    for role in ("D_A", "D_B"):
        m[role].load_state_dict(spec["critics1"][role])
    g_decisions = Decisions(spec["g_pre"], dp)
    with g_decisions.patched([m[role] for role in mod.MODULES]):
        state, g_out = g_step(state, *batch, masks=spec["masks"][2:])
    seen["local"] = {"worst": max(d_decisions.worst, g_decisions.worst)}
    return {**d_out, **g_out}, seen


def _run_stargan(mod, cfg, state, batch, spec, dp):
    """``tests/test_torch_port_stargan.py:_stargan`` on this rank's rows: the
    d_step with JAX's sampled attributes, alpha and decisions; JAX's critic
    after it; the g_step with JAX's decisions."""
    d_step, g_step = mod.make_steps(cfg, state)
    m = list(state.modules.values())
    d_decisions = Decisions(spec["d_pre"], dp)
    with d_decisions.patched(m):
        state, d_out = d_step(state, *batch, sampled_c=spec["sampled_c"], alpha=spec["alpha"])
    seen = {"d_stats": _sd(state.modules["generator"])}
    state.modules["discriminator"].load_state_dict(spec["critic1"])
    g_decisions = Decisions(spec["g_pre"], dp)
    with g_decisions.patched(m):
        state, g_out = g_step(state, *batch, d_out["sampled_c"])
    seen["local"] = {"worst": max(d_decisions.worst, g_decisions.worst),
                     "left": [next(d.pre, None) is None for d in (d_decisions, g_decisions)]}
    return {k: v for k, v in {**d_out, **g_out}.items() if v.ndim == 0}, seen


def _run_bicyclegan(mod, cfg, state, batch, spec, dp):
    """In float64, as ``tests/test_torch_port_bicyclegan.py:_step``."""
    from tpugan_torch.train import state as state_mod

    real = mod.normalize_uint8
    mod.normalize_uint8 = lambda x: state_mod.normalize_uint8(x).double()
    try:
        return _run_plain(mod, cfg, state, batch, spec, dp)
    finally:
        mod.normalize_uint8 = real


def _run_cluster_gan(mod, cfg, state, batch, spec, dp):
    """cluster_gan's ``full_step`` (a G+E update, then D's) with the spec's
    draws."""
    full_step, _ = mod.make_steps(cfg, state)
    return full_step(state, *batch, **spec["draws"])[1], {}


def _run_esrgan(mod, cfg, state, batch, spec, dp):
    """esrgan's warm-up step, or its full step in float64 (the modules cast
    by ``im2im_step``, the LR/HR pair resized in float32 and then cast), as
    ``tests/test_torch_port_sr.py:_esrgan``."""
    warmup_step, full_step = mod.make_steps(cfg, state)
    if spec["which"] == "warmup":
        return warmup_step(state, *batch)[1], {}
    pair = mod.prepare_lr_hr
    mod.prepare_lr_hr = lambda x, h: tuple(v.double() for v in pair(x, h))
    try:
        return full_step(state, *batch)[1], {}
    finally:
        mod.prepare_lr_hr = pair


RUNS = {"dualgan": _run_dualgan, "stargan": _run_stargan, "bicyclegan": _run_bicyclegan,
        "cluster_gan": _run_cluster_gan, "esrgan": _run_esrgan}


def im2im_step(spec: dict, dp) -> dict:
    """One step of ``spec["trainer"]`` from ``spec["init"]`` (the JAX initial
    weights in the port's layout) on this rank's rows of ``spec["batch"]``,
    with the JAX draws of ``spec`` (global, kept to this rank's rows by the
    step); ``dp`` None runs the single process on the whole batch. Returns
    the step's scalars, each optimizer's (gradient, parameter after) by
    (role, key) at each of its steps and the modules' buffers after (both
    named by ``model_blocks`` where ``spec["trunks"]``), the parameters left
    without a gradient and what the trainer's run saw (``seen``; its
    ``local`` entry is this rank's own, the rest equal on every rank)."""
    import importlib

    from tpugan_torch.parallel.mesh import local_rows, replicate_for

    mod = importlib.import_module(f"tpugan_torch.models.{spec['trainer']}")
    cfg = spec["cfg"]
    modules = mod.build(cfg, "cpu")
    for role, sd in spec["init"].items():
        modules[role].load_state_dict(sd)
    if spec.get("float64"):
        for m in modules.values():
            m.double()
    state = replicate_for(dp, mod.create_state(cfg, modules, "cpu"))
    named = ({k: getattr(m, "model_blocks", m) for k, m in modules.items()}
             if spec.get("trunks") else modules)
    rec = record_grads(named, state.optimizers)
    batch = [local_rows(dp, x) for x in spec["batch"]]
    out, seen = RUNS.get(spec["trainer"], _run_plain)(mod, cfg, state, batch, spec, dp)
    return {"out": {k: float(v) for k, v in out.items() if v.ndim == 0}, "grads": rec,
            "state": {r: {k: b.detach().clone() for k, b in m.named_buffers()}
                      for r, m in named.items()},
            "none": _grads_none(modules), "seen": seen}


@case
def im2im_steps(payload: dict, work_dir: str) -> dict:
    """``im2im_step`` of each spec of ``payload["steps"]`` on this rank, then
    the cases of ``payload["extra"]`` that ``EXTRA`` names. Rank 0 returns
    its tensors; the other ranks their ``digests``."""
    dp = _dp()
    res = {name: im2im_step(spec, dp) for name, spec in payload["steps"].items()}
    for name, spec in payload.get("extra", {}).items():
        res[name] = EXTRA[name](spec, dp, work_dir)
    return res if dp.rank == 0 else digests(res)


def tracked_in_case(spec, dp, work_dir) -> dict:
    """The tracked InstanceNorm's buffer updates from this rank's rows of
    ``spec["x"]``, ``spec["steps"]`` train forwards, and the frozen and
    eval forwards, which move nothing."""
    from tpugan_torch.nn.layers import InstanceNorm, batch_stats_frozen
    from tpugan_torch.parallel.mesh import local_rows

    layer = InstanceNorm(spec["x"].shape[2], affine=True, track_running_stats=True)
    layer.dp = dp
    for x in spec["x"]:
        layer(local_rows(dp, x))
    after = _sd(layer)
    with batch_stats_frozen(layer):
        layer(local_rows(dp, spec["x"][0]))
    layer.eval()
    layer(local_rows(dp, spec["x"][0]))
    return {"after": after, "frozen_eval": _sd(layer)}


def penalty_critic() -> torch.nn.Module:
    """A small critic with a BatchNorm(0.8) between its convs, as dualgan's."""
    from tpugan_torch.nn.layers import BatchNorm2d, Conv2d, LeakyReLU

    g = torch.Generator().manual_seed(0)
    return torch.nn.Sequential(
        Conv2d(3, 8, 4, 2, 1, init_mode="normal02", generator=g), LeakyReLU(0.2),
        Conv2d(8, 16, 4, 2, 1, init_mode="normal02", generator=g),
        BatchNorm2d(16, 0.8, init_mode="normal02", generator=g), LeakyReLU(0.2),
        Conv2d(16, 1, 3, 1, 1, init_mode="normal02", generator=g))


def penalty_case(spec, dp, work_dir) -> dict:
    """A WGAN-GP penalty through ``penalty_critic`` with a global BatchNorm,
    from this rank's rows: the penalty's global mean and the critic's
    gradient averaged over the ranks (a gradient of a gradient that crosses
    them)."""
    import torch.distributed as dist

    from tpugan_torch.nn.layers import BatchNorm2d, batch_stats_frozen
    from tpugan_torch.ops.penalty import wgan_gp_penalty
    from tpugan_torch.parallel.mesh import global_mean, local_rows

    critic = penalty_critic()
    for layer in critic.modules():
        if isinstance(layer, BatchNorm2d):
            layer.dp = dp
    with batch_stats_frozen(critic):
        gp = wgan_gp_penalty(critic, *(local_rows(dp, spec[k]) for k in ("real", "fake",
                                                                         "alpha")))
    gp.backward()
    grads = {}
    for k, p in critic.named_parameters():
        g = p.grad.clone() if p.grad is not None else torch.zeros_like(p)
        dist.all_reduce(g)
        grads[k] = g / dp.world
    return {"gp": float(global_mean(dp, gp)), "grads": grads}


def cli_case(spec, dp, work_dir) -> dict:
    """``spec["trainer"]``'s main from ``spec["argv"]``, each rank into its
    own output directory (and, with ``spec["metrics"]``, its
    ``--metrics_jsonl`` there); the modules it ends with."""
    import importlib

    mod = importlib.import_module(f"tpugan_torch.models.{spec['trainer']}")
    rank_dir = os.path.join(work_dir, "cli_rank%d" % dp.rank)
    os.makedirs(rank_dir)
    metrics = ["--metrics_jsonl", os.path.join(rank_dir, "metrics.jsonl")] if spec.get(
        "metrics") else []
    final = mod.main(spec["argv"] + ["--output_dir", rank_dir, *metrics], "cpu")
    return {"dir": rank_dir, "final": {n: _sd(m) for n, m in final.modules.items()}}


def _hinge(margin):
    def term(dp, x):
        from tpugan_torch.models.ebgan import fake_hinge

        return fake_hinge(dp, x[:, :2], x[:, 2:4], margin)

    return term


def _relativistic(dp, x):
    from tpugan_torch.losses import bce_with_logits
    from tpugan_torch.models.relativistic_gan import _centered

    return bce_with_logits(_centered(x[:, :1], x[:, 1:2], True, dp), 1.0)


def _partition(dp, x):
    from tpugan_torch.models.softmax_gan import log_partition

    return log_partition(dp, x[:, 0], x[:, 1])


def _pullaway(dp, x):
    from tpugan_torch.losses import pullaway
    from tpugan_torch.parallel.mesh import gather_rows

    return pullaway(gather_rows(dp, x))


def _std(dp, x):
    from tpugan_torch.parallel.mesh import global_std

    return global_std(dp, x)


# Each cross-sample term as a rank's scalar loss of its rows x (B/world, 4):
# global ones (the partition, the pull-away term, the hinge, the std) are
# the same on every rank; the relativistic loss is a mean over the rank's
# rows of a function of the global batch's mean. The ebgan hinge with
# margin 50 lies on its active side at the terms' inputs, with margin 0 on
# its flat side (``test_torch_port_parallel_batch_terms.py`` checks which).
TERMS = {"softmax_partition": _partition, "relativistic_mean": _relativistic,
         "pullaway": _pullaway, "ebgan_hinge_active": _hinge(50.0),
         "ebgan_hinge_flat": _hinge(0.0), "dragan_std": _std}


def term_step(name: str, dp, u: torch.Tensor, w: torch.Tensor) -> dict:
    """``TERMS[name]`` of x = u @ w on this rank's rows of ``u`` (all of it
    without ``dp``), its gradient with respect to ``w`` averaged over the
    ranks as the optimizer hook averages it (``parallel/mesh.py:
    _average_grads``), and the rank's value of the term (a float, which
    rank 1 reports as it is, not as a digest)."""
    import torch.distributed as dist

    from tpugan_torch.parallel.mesh import local_rows

    w = w.clone().requires_grad_(True)
    value = TERMS[name](dp, local_rows(dp, u) @ w)
    value.backward()
    grad = w.grad
    if dp is not None:
        dist.all_reduce(grad)
        grad = grad / dp.world
    return {"value": float(value.detach()), "grad": grad}


def terms_case(spec, dp, work_dir) -> dict:
    """``term_step`` of every term of ``TERMS`` on this rank, from the
    spec's global ``u`` and ``w``."""
    return {name: term_step(name, dp, spec["u"], spec["w"]) for name in TERMS}


EXTRA = {"tracked_in": tracked_in_case, "penalty": penalty_case, "cli": cli_case,
         "terms": terms_case}


def main() -> None:
    name, work_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    payload = torch.load(os.path.join(work_dir, "payload.pt"), weights_only=False)
    result = CASES[name](payload, work_dir)
    rank = int(os.environ["RANK"])
    torch.save(result, os.path.join(work_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
