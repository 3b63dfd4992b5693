"""Headline benchmark of the port: DCGAN training images/s at 64x64, batch 64.

    python -m tpugan_torch.bench

The full G+D step of ``tpugan_torch.models.dcgan`` (the entry points a
trainer calls), fp32 with TF32 off, on uint8 batches already on the card,
``STEPS`` = 60 steps a dispatch as the JAX bench fuses them (``bench.py:37``):
one CUDA graph of the 60 steps, replayed (``train.loop.graph_steps``).
``TPUGAN_BENCH_DTYPE`` takes the JAX bench's values (``bench.py:45-49``),
float32 or bfloat16 (``--dtype bfloat16``: bf16 convolutions and linears
over float32 master weights), but defaults to float32, the port's recorded
headline; ``measure(..., dtype=)`` takes the same. The first dispatch is the eager warm-up,
the second captures the graph; then the difference method of
``tpugan_torch.utils.benchtime`` times dispatches, each ending in
``torch.cuda.synchronize()``. It takes no flags: the shape is the
headline's. Prints one JSON line: ``metric``, ``value``, ``unit``,
``dtype``, ``mode`` (``cuda_graph``), ``steps_per_dispatch``, the capture's
and the instantiation's host seconds, and the card's name and power limit
as ``nvidia-smi`` gives them. It runs on CUDA unless ``main`` is given
another device (the tests pass the CPU, where ``graph_steps`` loops in
Python, the mode says so and the line names no card); it raises without
CUDA. Nothing is compared with the JAX package's numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from tpugan_torch.models import dcgan
from tpugan_torch.train.loop import graph_steps, train_device

METRIC = "dcgan_train_images_per_sec_64px"
IMG_SIZE, BATCH_SIZE, STEPS = 64, 64, 60


def _card(device: torch.device):
    """nvidia-smi's ``name, power.limit`` of the card, None off CUDA."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(img_size: int, batch_size: int, steps: int, device=None, seed: int = 0,
            dtype: str = "float32") -> dict:
    """Train DCGAN at ``img_size`` and ``batch_size`` on ``steps`` distinct
    device-resident batches a ``graph_steps`` dispatch, in ``dtype``
    (float32 or bfloat16); return what was measured."""
    from tpugan_torch.utils.benchtime import measure_images_per_sec

    cfg = dcgan.Config(img_size=img_size, batch_size=batch_size, synthetic_data=True, seed=seed,
                       dtype=dtype)
    device = train_device(cfg, device)
    modules = dcgan.build(cfg, device)
    state = dcgan.create_state(cfg, modules, device)
    fused = graph_steps(dcgan.make_step(cfg, state), steps)
    rng = np.random.default_rng(seed)
    batches = torch.from_numpy(
        rng.integers(0, 255, (steps, batch_size, img_size, img_size, cfg.channels), dtype=np.uint8)
    ).to(device)
    out = {}

    def dispatch(n: int) -> float:
        nonlocal state, out
        t0 = time.perf_counter()
        for _ in range(n):
            state, out = fused(state, batches)
        _sync(device)
        return time.perf_counter() - t0

    dispatch(1)  # the eager warm-up
    dispatch(1)  # the capture, then a replay
    ips = measure_images_per_sec(dispatch, steps * batch_size, 1, 4)
    if not all(bool(torch.isfinite(out[k]).all()) for k in ("d_loss", "g_loss")):
        raise RuntimeError(f"non-finite losses in the timed steps: {out['d_loss']}, "
                           f"{out['g_loss']}")
    losses = {k: float(out[k][-1]) for k in ("d_loss", "g_loss")}
    return {
        "value": ips,
        "unit": "images/sec/gpu" if device.type == "cuda" else f"images/sec/{device.type}",
        "dtype": dtype,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "card": _card(device),
        "img_size": img_size,
        "batch_size": batch_size,
        "steps_per_dispatch": steps,
        "mode": "cuda_graph" if device.type == "cuda" else "python_loop",
        "capture_s": fused.capture_s,
        "instantiate_s": fused.instantiate_s,
        "losses": losses,
    }


def main(device=None) -> dict:
    dtype = os.environ.get("TPUGAN_BENCH_DTYPE", "float32")
    if dtype not in ("float32", "bfloat16"):
        raise SystemExit(f"TPUGAN_BENCH_DTYPE={dtype!r}: expected float32 or bfloat16")
    rec = {"metric": METRIC, **measure(IMG_SIZE, BATCH_SIZE, STEPS, device, dtype=dtype)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
