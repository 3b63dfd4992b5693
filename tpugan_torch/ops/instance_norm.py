"""Instance norm + leaky activation: the Hopper kernel pair and its plain
PyTorch version.

Replaces three Pallas TPU kernels of ``tpugan/ops/pallas_kernels.py`` that
compute one function: ``instance_norm_pallas`` (:114, plain IN),
``instance_norm_act_pallas`` (:294, IN + (Leaky)ReLU) and
``instance_norm_act_tiled`` (:597, the same for maps above the TPU's VMEM
envelope). ``slope`` selects the activation: 1.0 is identity, 0.0 ReLU,
0.2 LeakyReLU(0.2). The kernels are ``tpugan_torch/csrc/instance_norm.cu``
on contiguous NCHW float32 or bfloat16 (``--dtype bfloat16``, where the
convolutions hand the norms bf16 maps), bound by memory bandwidth: 8 bytes
an element forward (x in, y out) and 12 backward (g and x in, dx out) in
float32, 4 and 6 in bf16, which they reach by reading each input once. A
bf16 map keeps float32 statistics: mean and rstd are float32, the sums and
the normalize run in float32, and each output is rounded to bf16 once, as
the plain bf16 version here computes. :func:`plan` picks one of two regimes
a call: A, H*W <= 256, a warp a plane with the values in registers; B, every larger
plane, each CTA holding its slice of the plane in shared memory, and a
plane larger than one CTA's share (64 KB) split over a thread block cluster
of 2, 4 or 8 CTAs that add their partial sums in a fixed rank order.

Dispatch is by device and dtype: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel of its dtype or raises; nothing converts a
map to reach the other kernel. ``fwd_launches`` and ``bwd_launches`` count
float32 wrapper calls that launched, and only those, ``fwd_launches_bf16``
and ``bwd_launches_bf16`` bf16 ones; ``fwd_captured`` and ``bwd_captured``
(and their ``_bf16`` twins) count those of them made while the current
stream was capturing a CUDA graph. A captured call counts once
however often its graph is replayed: the kernels that ran on the device are
the calls not captured plus each captured call times its graph's replays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpugan_torch.ops._build import LaunchPlan, check_tensors, library

fwd_launches = 0
bwd_launches = 0
fwd_captured = 0
bwd_captured = 0
fwd_launches_bf16 = 0
bwd_launches_bf16 = 0
fwd_captured_bf16 = 0
bwd_captured_bf16 = 0

# The map dtypes the kernels take, and each one's element size in bytes.
KERNEL_DTYPES = {torch.float32: 4, torch.bfloat16: 2}

# The launch plan's constants (see ``plan``).
SMS = 132  # streaming multiprocessors of the H100 SXM
WARP_HW_MAX = 256  # regime A: a warp holds a plane at 8 values a lane
SLICE_BYTES_MAX = 64 * 1024  # regime B: shared memory a CTA holds its slice in
SLICE_BYTES_MIN = 16 * 1024  # regime B: the least slice a plane is split down to
CLUSTER_MAX = 8  # the portable thread block cluster size


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches, fwd_captured, bwd_captured
    global fwd_launches_bf16, bwd_launches_bf16, fwd_captured_bf16, bwd_captured_bf16
    fwd_launches = bwd_launches = fwd_captured = bwd_captured = 0
    fwd_launches_bf16 = bwd_launches_bf16 = fwd_captured_bf16 = bwd_captured_bf16 = 0


class Plan(NamedTuple):
    """How one call's planes map onto the card (``instance_norm.cu``)."""

    regime: str  # "A": a warp a plane; "B": slices of a plane in shared memory
    group: int  # A: planes a CTA; B: CTAs a plane, the cluster size
    slice: int  # B: elements of the plane a CTA owns (whole 16-byte vectors); A: 0
    held: int  # B: elements of the slice held in shared memory; A: 0
    threads: int  # a CTA
    grid: int  # CTAs
    smem: int  # dynamic shared memory a CTA, bytes


def _slice(hw: int, c: int, lanes: int = 4) -> int:
    """H*W over c CTAs: ceil(hw / c), rounded up to whole 16-byte vectors of
    ``lanes`` elements (4 floats, 8 bf16)."""
    return (-(-hw // c) + lanes - 1) // lanes * lanes


@functools.lru_cache(maxsize=1024)
def plan(planes: int, hw: int, direction: str, elem: int = 4) -> Plan:
    """The launch plan for ``planes`` planes of ``hw`` elements of ``elem``
    bytes (4 float32, 2 bf16), ``"fwd"`` or ``"bwd"``.

    Regime A (hw <= 256): 8 planes a CTA, halved down to 1 while that gives
    fewer CTAs than SMs. Regime B: c is the smallest power of two up to 8
    whose slice takes at most 64 KB of shared memory (``elem`` bytes an
    element forward, twice that backward: g and x); then c doubles, up to 8,
    while planes * c < 132 SMs and the slice stays at least 16 KB. A slice
    beyond 64 KB even at c = 8 holds its first 64 KB in shared memory.
    Slices are whole 16-byte vectors. A bf16 plane never takes a larger
    cluster than the float32 plan's, often half. Threads: 16 elements each, from 64 to 256
    (512 was no faster on the H100 at any CycleGAN or MUNIT shape:
    ``scripts/sweep_in_plan.py``)."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction {direction!r}, expected 'fwd' or 'bwd'")
    if elem not in KERNEL_DTYPES.values():
        raise ValueError(f"element size {elem}, expected one of {set(KERNEL_DTYPES.values())}")
    if planes <= 0 or hw <= 0:
        raise ValueError(f"no work: {planes} planes of {hw} elements")
    if hw <= WARP_HW_MAX:
        group = 8
        while group > 1 and -(-planes // group) < SMS:
            group //= 2
        grid = -(-planes // group)
        return Plan("A", group, 0, 0, 32 * group, grid, 0)
    per = elem if direction == "fwd" else 2 * elem
    lanes = 16 // elem
    c = 1
    while c < CLUSTER_MAX and _slice(hw, c, lanes) * per > SLICE_BYTES_MAX:
        c *= 2
    while (c < CLUSTER_MAX and planes * c < SMS
           and _slice(hw, 2 * c, lanes) * per >= SLICE_BYTES_MIN):
        c *= 2
    size = _slice(hw, c, lanes)
    held = min(size, SLICE_BYTES_MAX // per)
    threads = 64
    while threads < 256 and threads * 16 < size:
        threads *= 2
    return Plan("B", c, size, held, threads, planes * c, held * per)


def _planes(x: torch.Tensor):
    b, c = x.shape[:2]
    return b * c, x[0, 0].numel()


def in_act_fwd_ref(x: torch.Tensor, eps: float, slope: float):
    """Plain version of the forward kernel: (y, mean, rstd), the statistics
    of shape (B*C,). The variance is centred (two passes), as
    ``instance_norm_xla``'s ``jnp.var``. A bf16 x is widened to float32,
    takes the float32 math and float32 statistics, and y is rounded to bf16
    once."""
    if x.dtype is torch.bfloat16:
        y, mean, rstd = in_act_fwd_ref(x.float(), eps, slope)
        return y.to(x.dtype), mean, rstd
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
    is 1 where xh >= 0 (so 1 at exactly 0, as JAX's ``where`` gives). bf16 g
    and x are widened, and dx is rounded to bf16 once."""
    if x.dtype is torch.bfloat16:
        return in_act_bwd_ref(g.float(), x.float(), mean, rstd, slope).to(x.dtype)
    planes, hw = _planes(x)
    xh = (x.reshape(planes, hw) - mean[:, None]) * rstd[:, None]
    gh = g.reshape(planes, hw) * torch.where(xh >= 0, 1.0, slope)
    dx = (gh - gh.mean(dim=1, keepdim=True) - xh * (gh * xh).mean(dim=1, keepdim=True)) * rstd[:, None]
    return dx.reshape(x.shape)


@functools.lru_cache(maxsize=1024)
def _plan_arg(planes: int, hw: int, direction: str, elem: int = 4):
    """The plan for a launch and the C struct ctypes passes for it."""
    p = plan(planes, hw, direction, elem)
    return p, _c_plan(p, planes, hw)


def _c_plan(p: Plan, planes: int, hw: int):
    return ctypes.byref(LaunchPlan(planes, hw, p.group, p.slice, p.held, p.threads))


# The float32 C entry points, the raw-stream reader, the capture query
# (``torch.cuda.is_current_stream_capturing`` without its checks) and the
# bf16 entry points, bound at the first launch.
_bound = None


def _bind():
    global _bound
    lib = library()
    # The value of torch.cuda.current_stream(index).cuda_stream, without
    # building a Stream object (CUDA builds of torch only).
    _bound = (lib.in_act_fwd, lib.in_act_bwd, torch._C._cuda_getCurrentRawStream,
              torch._C._cuda_isCurrentStreamCapturing, lib.in_act_fwd_bf16,
              lib.in_act_bwd_bf16)
    return _bound


def _map_dtype(name: str, dev: int, *maps) -> torch.dtype:
    """The kernel dtype of a call: the first map's, which every map must
    share (``check_tensors`` raises otherwise); float32 is what a map of
    another dtype is refused against."""
    dtype = maps[0].dtype if maps[0].dtype in KERNEL_DTYPES else torch.float32
    check_tensors(name, dev, *maps, dtype=dtype)
    return dtype


def per_plane_strides(name: str, x, *ts, dev=None) -> list:
    """The row strides of AdaIN's per-plane tensors ``ts`` (w, and b
    forward) for the NCHW map x, as the affine kernels read them in place:
    each of x's dtype (TypeError otherwise: no call mixes a bf16 map with
    float32 w, or the reverse), of shape (B, C), with the C entries of a row
    adjacent (last stride 1; ValueError otherwise). Its rows may lie any
    stride apart, so a column slice of the style MLP's (B, 4C x blocks)
    output is taken as it is. Plain Python: it runs without CUDA; ``dev``,
    where given, is the CUDA device every tensor must lie on."""
    n, c = x.shape[:2]
    strides = []
    for t in ts:
        if dev is not None and not (t.is_cuda and t.get_device() == dev):
            raise ValueError(f"{name}: a tensor on {t.device}, expected all on cuda:{dev}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: per-plane dtype {t.dtype}, the map's is {x.dtype}")
        if t.shape != (n, c):
            raise ValueError(f"{name}: per-plane tensor of shape {tuple(t.shape)}, expected "
                             f"{(n, c)}")
        stride = t.stride()
        if c > 1 and stride[1] != 1:
            raise ValueError(f"{name}: per-plane tensor with column stride {stride[1]}, "
                             "expected 1")
        strides.append(stride[0])
    return strides


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer, read anew
    at every launch (a CUDA-graph capture swaps it)."""
    return (_bound or _bind())[2](index)


def _raise_on(rc: int, name: str, p: Plan, planes: int, hw: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch; {planes} planes of {hw}, {p}")


def _launch_fwd(name: str, x, eps: float, slope: float, w=None, b=None):
    """Checks a CUDA input and launches the forward of ``instance_norm.cu``
    for x's dtype at ``slope``, or AdaIN given the per-plane w and b of shape
    (B, C) in x's dtype, read through their row strides
    (``per_plane_strides``). Returns (y, mean, rstd), the statistics
    float32."""
    dev = x.get_device()
    dtype = _map_dtype(name, dev, x)
    shape = x.shape
    if len(shape) != 4 or 0 in shape:
        raise ValueError(f"{name}: expected a non-empty NCHW tensor, got {tuple(shape)}")
    n, c, h, wd = shape
    ldw, ldb = (0, 0) if w is None else per_plane_strides(name, x, w, b, dev=dev)
    planes, hw = n * c, h * wd
    p, cp = _plan_arg(planes, hw, "fwd", KERNEL_DTYPES[dtype])
    bound = _bound or _bind()
    fwd, stream = bound[0 if dtype is torch.float32 else 4], bound[2]
    y = torch.empty_like(x)
    mean = x.new_empty(planes, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    rc = fwd(x.data_ptr(), None if w is None else w.data_ptr(),
             None if b is None else b.data_ptr(), y.data_ptr(), mean.data_ptr(),
             rstd.data_ptr(), eps, slope, c, ldw, ldb, cp, stream(dev))
    _raise_on(rc, name, p, planes, hw)
    return y, mean, rstd


def _launch_bwd(name: str, g, x, mean, rstd, slope: float, w=None):
    """Checks CUDA inputs and launches the backward of ``instance_norm.cu``
    for x's dtype (g's too) at ``slope``, returning dx, or AdaIN's given w
    as the forward takes it, returning (dx, dw, dbias), dw and dbias
    contiguous (B, C) in x's dtype."""
    dev = x.get_device()
    dtype = _map_dtype(name, dev, x, g)
    check_tensors(name, dev, mean, rstd)
    shape = x.shape
    if len(shape) != 4 or 0 in shape:
        raise ValueError(f"{name}: expected a non-empty NCHW tensor, got {tuple(shape)}")
    n, c, h, wd = shape
    planes, hw = n * c, h * wd
    if g.shape != shape or mean.shape != (planes,) or rstd.shape != (planes,):
        raise ValueError(
            f"{name}: shapes g {tuple(g.shape)}, x {tuple(shape)}, mean {tuple(mean.shape)}, "
            f"rstd {tuple(rstd.shape)} do not agree"
        )
    ldw = 0 if w is None else per_plane_strides(name, x, w, dev=dev)[0]
    p, cp = _plan_arg(planes, hw, "bwd", KERNEL_DTYPES[dtype])
    bound = _bound or _bind()
    bwd, stream = bound[1 if dtype is torch.float32 else 5], bound[2]
    dx = torch.empty_like(x)
    if w is None:
        rc = bwd(g.data_ptr(), x.data_ptr(), None, mean.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), None, None, slope, 0, 0, cp, stream(dev))
        _raise_on(rc, name, p, planes, hw)
        return dx
    dw = x.new_empty((n, c))
    db = x.new_empty((n, c))
    rc = bwd(g.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
             dx.data_ptr(), dw.data_ptr(), db.data_ptr(), 1.0, c, ldw, cp, stream(dev))
    _raise_on(rc, name, p, planes, hw)
    return dx, dw, db


def in_act_fwd(x: torch.Tensor, eps: float, slope: float):
    """Forward wrapper: (y, mean, rstd). CPU tensors take the plain version;
    CUDA tensors launch ``in_act_fwd`` (float32) or ``in_act_fwd_bf16`` of
    ``instance_norm.cu``."""
    global fwd_launches, fwd_captured, fwd_launches_bf16, fwd_captured_bf16
    if x.is_cpu:
        return in_act_fwd_ref(x, eps, slope)
    out = _launch_fwd("in_act_fwd", x, eps, slope)
    if x.dtype is torch.bfloat16:
        fwd_launches_bf16 += 1
        fwd_captured_bf16 += _bound[3]()
    else:
        fwd_launches += 1
        fwd_captured += _bound[3]()
    return out


def in_act_bwd(g, x, mean, rstd, slope: float):
    """Backward wrapper: dx. CPU tensors take the plain version; CUDA
    tensors launch ``in_act_bwd`` (float32) or ``in_act_bwd_bf16`` of
    ``instance_norm.cu``."""
    global bwd_launches, bwd_captured, bwd_launches_bf16, bwd_captured_bf16
    if x.is_cpu:
        return in_act_bwd_ref(g, x, mean, rstd, slope)
    dx = _launch_bwd("in_act_bwd", g, x, mean, rstd, slope)
    if x.dtype is torch.bfloat16:
        bwd_launches_bf16 += 1
        bwd_captured_bf16 += _bound[3]()
    else:
        bwd_launches += 1
        bwd_captured += _bound[3]()
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
