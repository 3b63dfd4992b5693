"""One data-parallel DCGAN step over n ranks at tiny shapes: the port's
counterpart of ``__graft_entry__.py:dryrun_multichip`` (:81-108), which runs
one full DP step over an n-device mesh.

    python -m tpugan_torch.parallel.dryrun N [DEVICE]

``dryrun_multichip(n, device)`` spawns n processes, each one rank of a group
on 127.0.0.1: NCCL, one card a rank, when ``device`` is CUDA and there are n
cards; gloo otherwise (the CPU, or several ranks sharing one card). Each rank
builds DCGAN at 16px with latent 8 and a global batch of 2n, replicates it
(``replicate_for``), and takes one step on its share of a zero batch; the
global losses must be finite and the same on every rank.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import sys
import traceback

import torch

_TIMEOUT_S = 300


def free_port() -> int:
    """A TCP port free on 127.0.0.1 when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, n: int, device: str, port: int, results) -> None:
    import torch.distributed as dist

    from tpugan_torch.models import dcgan
    from tpugan_torch.parallel.mesh import auto_sharding, replicate_for

    try:
        torch.set_num_threads(1)
        device = torch.device(device)
        nccl = device.type == "cuda" and torch.cuda.device_count() >= n
        if nccl:
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if nccl else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=n, device_id=device if nccl else None)
        try:
            batch = 2 * n
            cfg = dcgan.Config(img_size=16, channels=1, latent_dim=8, batch_size=batch,
                               synthetic_data=True)
            modules = dcgan.build(cfg, device)
            dp = auto_sharding(batch, device)
            state = replicate_for(dp, dcgan.create_state(cfg, modules, device))
            step = dcgan.make_step(cfg, state)
            imgs = torch.zeros(batch // n, cfg.img_size, cfg.img_size, cfg.channels,
                               dtype=torch.uint8)
            state, out = step(state, imgs)
            results.put((rank, dist.get_backend(), float(out["d_loss"]), float(out["g_loss"])))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc(), None))
        raise


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full DCGAN data-parallel step over ``n_devices`` ranks; returns
    the backend and the global losses. Raises if a rank fails, or the ranks
    disagree, or a loss is not finite."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(r, n_devices, str(device), port, results))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(n_devices):
            rank, backend, d_loss, g_loss = results.get(timeout=_TIMEOUT_S)
            if backend == "error":
                raise RuntimeError(f"dryrun_multichip: rank {rank} failed:\n{d_loss}")
            got[rank] = (backend, d_loss, g_loss)
    except queue.Empty:
        raise RuntimeError(f"dryrun_multichip: ranks {sorted(set(range(n_devices)) - set(got))} "
                           f"sent nothing in {_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            p.join(timeout=_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    if len(set(got.values())) != 1:
        raise AssertionError(f"dryrun_multichip: the ranks disagree: {got}")
    backend, d_loss, g_loss = got[0]
    if not (torch.isfinite(torch.tensor([d_loss, g_loss])).all()):
        raise AssertionError(f"dryrun_multichip: losses {d_loss}, {g_loss}")
    print(f"dryrun_multichip({n_devices}): dcgan ok over {backend} — d_loss={d_loss:.4f} "
          f"g_loss={g_loss:.4f}")
    return {"backend": backend, "d_loss": d_loss, "g_loss": g_loss}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else "cuda")
