"""The AdaIN pair's outputs on the card at fixed inputs, written to a file,
and held bit for bit against the file another checkout wrote.

    python3 scripts/adain_bits.py OUT.pt [--against OTHER.pt]

Run it from the root of a checkout, on a machine with a CUDA card: it
imports that checkout's ``tpugan_torch`` and ``chip_smoke.py``, so the same
script run in two checkouts compares their kernels on the same inputs. The
inputs are ``chip_smoke.ADAIN_CASES`` in float32 and bf16, made by
``chip_smoke._adain_inputs`` from seed 11, with w and bias contiguous; the
outputs are ``adain_fwd``'s (y, mean, rstd) and ``adain_bwd``'s (dx, dw,
dbias, given the plain version's mean and rstd). Then, at the MUNIT step and
sample shapes, ``adain()`` on column slices of a (B, 12C) tensor, as the
residual blocks take them, forward and backward through autograd: y, dx and
the (B, 12C) gradient. With ``--against`` it exits 1 unless every output has
the other file's dtype, shape and bits.
"""

import argparse
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def outputs() -> dict:
    from tpugan_torch.ops import adain as ta

    eps = chip_smoke.EPS
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, offset, w_kind in chip_smoke.ADAIN_CASES:
            x, w, bias, g = (t.to(dtype) for t in
                             chip_smoke._adain_inputs(shape, offset, w_kind, gen))
            _, mean, rstd = ta.adain_fwd_ref(x, w, bias, eps)
            got = (*ta.adain_fwd(x, w, bias, eps), *ta.adain_bwd(g, x, w, mean, rstd))
            for name, t in zip(("y", "mean", "rstd", "dx", "dw", "db"), got):
                out[f"{dtype} {shape} {offset} {w_kind} {name}"] = t
        for shape in (chip_smoke.ADAIN_STEP_SHAPE, chip_smoke.ADAIN_SAMPLE_SHAPE):
            b, c = shape[:2]
            x, _, _, g = (t.to(dtype) for t in chip_smoke._adain_inputs(shape, 0.0, "normal", gen))
            params = (0.5 + 0.5 * torch.randn((b, 12 * c), device="cuda", generator=gen)).to(dtype)
            params.requires_grad_()
            x.requires_grad_()
            y = ta.adain(x, params[:, c:2 * c], params[:, :c], eps)
            got = (y, *torch.autograd.grad(y, (x, params), g))
            for name, t in zip(("y", "dx", "dparams"), got):
                out[f"{dtype} {shape} adain() {name}"] = t.detach()
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adain_bits: needs a CUDA card")
    mine = outputs()
    torch.save(mine, args.out)
    print(f"[adain bits] {len(mine)} outputs of {os.getcwd()} on "
          f"{torch.cuda.get_device_name(0)} written to {args.out}")
    if not args.against:
        return 0
    other = torch.load(args.against)
    differ = [k for k in mine if k not in other or other[k].dtype != mine[k].dtype
              or other[k].shape != mine[k].shape or not torch.equal(other[k], mine[k])]
    for k in differ[:20]:
        print(f"[adain bits] differs: {k}")
    print(f"[adain bits] {len(mine) - len(differ)} of {len(mine)} outputs equal, bit for bit, "
          f"to {args.against}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
