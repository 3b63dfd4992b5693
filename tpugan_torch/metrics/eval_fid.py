"""FID of a generator of the port against its recipe's data
(``scripts/eval_fid.py``):

    python -m tpugan_torch.metrics.eval_fid --model dcgan --n_samples 2048 \\
        [--state saved_models/generator_N.pth] [--extractor auto|inception|vgg]

Draws ``n_samples`` images from the registry's generator on the card (a
fresh one from ``--seed``'s init, or ``--state``: the port's own
``state_dict`` of the generator; the JAX package's msgpack state is not
read), in train mode as the JAX script applies it, with z from a generator
seeded 123; reads as many real images from the recipe's loader (MNIST, or
the synthetic set); and prints the JAX script's JSON line,
``{"model": ..., "fid": ..., "n": ...}``. The extractor is InceptionV3 when
``<data_dir>/inception_v3.npz`` is there, else VGG19 (``metrics.fid``);
He-random without weights, which compares only within one framework.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpugan_torch.metrics.fid import (
    InceptionFeatureModel,
    VGGFeatureModel,
    feature_model,
    fid_from_features,
)
from tpugan_torch.models import registry
from tpugan_torch.train.loop import train_device
from tpugan_torch.train.state import normalize_uint8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tpugan_torch.metrics.eval_fid")
    ap.add_argument("--model", default="dcgan")
    ap.add_argument("--n_samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--data_dir", default="data")
    ap.add_argument("--state", default="", help="optional state_dict of the generator (.pth)")
    ap.add_argument("--synthetic_data", action="store_true")
    ap.add_argument("--extractor", default="auto", choices=("auto", "inception", "vgg"))
    return ap.parse_args(argv)


def evaluate(args, device=None) -> dict:
    """The FID of ``args`` and how it was taken: the extractor's class,
    whether it loaded weights, and the host seconds and images/s of the
    feature extraction over both sets (synchronized on CUDA). ``device``
    None means CUDA, and raises when there is none."""
    recipe = registry.get(args.model)
    cfg = recipe.Config(data_dir=args.data_dir, synthetic_data=args.synthetic_data)
    device = train_device(cfg, device)
    G = recipe.build(cfg, device)["generator"]
    if args.state:
        G.load_state_dict(torch.load(args.state, map_location="cpu", weights_only=True))
    G.train()
    draws = torch.Generator(device=device).manual_seed(123)
    with torch.no_grad():
        fake = [G(torch.randn(args.batch, cfg.latent_dim, generator=draws, device=device))
                for _ in range(-(-args.n_samples // args.batch))]
    real, seen = [], 0
    batches = recipe.make_loader(cfg, device).epoch(0)
    try:
        for batch in batches:
            real.append(normalize_uint8(batch[0]))
            seen += real[-1].shape[0]
            if seen >= args.n_samples:
                break
    finally:
        batches.close()
    if args.extractor == "auto":
        model = feature_model(args.data_dir, device=device)
    elif args.extractor == "inception":
        model = InceptionFeatureModel(args.data_dir, device=device)
    else:
        model = VGGFeatureModel(args.data_dir, device=device)
    t0 = time.perf_counter()
    feats_real = model(real)[: args.n_samples]
    feats_fake = model(fake)[: args.n_samples]
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    images = sum(b.shape[0] for b in real) + sum(b.shape[0] for b in fake)
    return {"model": args.model, "fid": fid_from_features(feats_real, feats_fake),
            "n": args.n_samples, "extractor": type(model).__name__,
            "pretrained": model.pretrained, "features": int(feats_real.shape[1]),
            "extract_s": seconds, "images_per_s": images / seconds,
            "finite": bool(np.isfinite(feats_real).all() and np.isfinite(feats_fake).all())}


def main(argv=None, device=None) -> dict:
    rec = evaluate(parse_args(argv), device)
    print(json.dumps({"model": rec["model"], "fid": round(rec["fid"], 3), "n": rec["n"]}))
    return rec


if __name__ == "__main__":
    main()
