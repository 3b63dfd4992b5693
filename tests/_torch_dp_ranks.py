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
    return [torch.load(os.path.join(work_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


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
