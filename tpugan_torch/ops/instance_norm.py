"""Instance norm + leaky activation: the Hopper kernel pair and its plain
PyTorch version.

Replaces three Pallas TPU kernels of ``tpugan/ops/pallas_kernels.py`` that
compute one function: ``instance_norm_pallas`` (:114, plain IN),
``instance_norm_act_pallas`` (:294, IN + (Leaky)ReLU) and
``instance_norm_act_tiled`` (:597, the same for maps above the TPU's VMEM
envelope). ``slope`` selects the activation: 1.0 is identity, 0.0 ReLU,
0.2 LeakyReLU(0.2). The kernels are ``tpugan_torch/csrc/instance_norm.cu``:
one thread block per (sample, channel) plane of contiguous NCHW float32.
They are bound by memory bandwidth: the forward reads x up to three times and
writes y once, the backward reads g and x twice and writes dx once.

Dispatch is by device and nothing else: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. ``fwd_launches`` and
``bwd_launches`` count kernel launches, and only those.
"""

from __future__ import annotations

import torch

fwd_launches = 0
bwd_launches = 0


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def _planes(x: torch.Tensor):
    b, c = x.shape[:2]
    return b * c, x[0, 0].numel()


def in_act_fwd_ref(x: torch.Tensor, eps: float, slope: float):
    """Plain version of the forward kernel: (y, mean, rstd), the statistics
    of shape (B*C,). The variance is centred (two passes), as
    ``instance_norm_xla``'s ``jnp.var``."""
    planes, hw = _planes(x)
    x2 = x.reshape(planes, hw)
    mean = x2.mean(dim=1)
    xc = x2 - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=1) + eps)
    xh = xc * rstd[:, None]
    y = torch.where(xh >= 0, xh, slope * xh)
    return y.reshape(x.shape), mean, rstd


def in_act_bwd_ref(g, x, mean, rstd, slope: float):
    """Plain version of the backward kernel: dx. The activation's gradient
    is 1 where xh >= 0 (so 1 at exactly 0, as JAX's ``where`` gives)."""
    planes, hw = _planes(x)
    xh = (x.reshape(planes, hw) - mean[:, None]) * rstd[:, None]
    gh = g.reshape(planes, hw) * torch.where(xh >= 0, 1.0, slope)
    dx = (gh - gh.mean(dim=1, keepdim=True) - xh * (gh * xh).mean(dim=1, keepdim=True)) * rstd[:, None]
    return dx.reshape(x.shape)


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device}, expected all on CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input of shape {tuple(t.shape)}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _launch_fwd(name: str, x, eps: float, slope: float, w=None, b=None):
    """Checks a CUDA input and launches the forward of ``instance_norm.cu``:
    ``in_act_fwd`` at ``slope``, or ``adain_fwd`` given the per-plane w and b
    of shape (B, C). Returns (y, mean, rstd)."""
    affine = w is not None
    _check_cuda(name, x, *((w, b) if affine else ()))
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty NCHW tensor, got {tuple(x.shape)}")
    for t in (w, b) if affine else ():
        if t.shape != x.shape[:2]:
            raise ValueError(f"{name}: per-plane tensor {tuple(t.shape)}, expected "
                             f"{tuple(x.shape[:2])}")
    from tpugan_torch.ops._build import library

    planes, hw = _planes(x)
    y = torch.empty_like(x)
    mean = torch.empty(planes, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if affine:
        rc = library().adain_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                 mean.data_ptr(), rstd.data_ptr(), planes, hw, eps, stream)
    else:
        rc = library().in_act_fwd(x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                  planes, hw, eps, slope, stream)
    _raise_on(rc, name)
    return y, mean, rstd


def _launch_bwd(name: str, g, x, mean, rstd, slope: float, w=None):
    """Checks CUDA inputs and launches the backward of ``instance_norm.cu``:
    ``in_act_bwd`` at ``slope``, returning dx, or ``adain_bwd`` given w,
    returning (dx, dw, dbias)."""
    affine = w is not None
    _check_cuda(name, g, x, mean, rstd, *((w,) if affine else ()))
    planes, hw = _planes(x)
    if g.shape != x.shape or mean.shape != (planes,) or rstd.shape != (planes,) or (
            affine and w.shape != x.shape[:2]):
        raise ValueError(
            f"{name}: shapes g {tuple(g.shape)}, x {tuple(x.shape)}, mean {tuple(mean.shape)}, "
            f"rstd {tuple(rstd.shape)}{f', w {tuple(w.shape)}' if affine else ''} do not agree"
        )
    from tpugan_torch.ops._build import library

    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if affine:
        dw, db = torch.empty_like(w), torch.empty_like(w)
        rc = library().adain_bwd(g.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(),
                                 rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                 planes, hw, stream)
    else:
        rc = library().in_act_bwd(g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                  dx.data_ptr(), planes, hw, slope, stream)
    _raise_on(rc, name)
    return (dx, dw, db) if affine else dx


def in_act_fwd(x: torch.Tensor, eps: float, slope: float):
    """Forward wrapper: (y, mean, rstd). CPU tensors take the plain version;
    CUDA tensors launch ``in_act_fwd`` of ``instance_norm.cu``."""
    global fwd_launches
    if x.device.type == "cpu":
        return in_act_fwd_ref(x, eps, slope)
    out = _launch_fwd("in_act_fwd", x, eps, slope)
    fwd_launches += 1
    return out


def in_act_bwd(g, x, mean, rstd, slope: float):
    """Backward wrapper: dx. CPU tensors take the plain version; CUDA
    tensors launch ``in_act_bwd`` of ``instance_norm.cu``."""
    global bwd_launches
    if x.device.type == "cpu":
        return in_act_bwd_ref(g, x, mean, rstd, slope)
    dx = _launch_bwd("in_act_bwd", g, x, mean, rstd, slope)
    bwd_launches += 1
    return dx


class InstanceNormAct(torch.autograd.Function):
    """IN + leaky(slope) with the kernel pair as forward and backward. Saves
    x, mean and rstd, as the Pallas VJP keeps its residuals."""

    @staticmethod
    def forward(ctx, x, slope: float, eps: float):
        y, mean, rstd = in_act_fwd(x, eps, slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        return in_act_bwd(g.contiguous(), x, mean, rstd, ctx.slope), None, None


def instance_norm_act(x: torch.Tensor, slope: float, eps: float = 1e-5) -> torch.Tensor:
    """IN (affine=False) followed by leaky(slope) on NCHW."""
    return InstanceNormAct.apply(x, slope, eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.InstanceNorm2d(affine=False) on NCHW through the same kernel."""
    return InstanceNormAct.apply(x, 1.0, eps)
