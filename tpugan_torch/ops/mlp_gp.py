"""Closed-form WGAN-GP for the template-A MLP critic: the Hopper kernel pair,
its launch plan and its plain PyTorch version.

Replaces the Pallas TPU kernels of ``tpugan/ops/pallas_critic.py``:
``mlp_gp_pallas`` (:202), ``_gp_fwd_kernel`` (:151) and ``_gp_bwd_kernel``
(:165). For the critic flat image -> N1 -> N2 -> 1 with LeakyReLU(0.2) and
no sigmoid, the input gradient and the penalty's parameter gradients have a
closed form (the docstring of ``pallas_critic.py``, :1-20), so the
double-backward needs no autograd graph. The kernels are
``tpugan_torch/csrc/mlp_gp.cu``: eight FP32 products with mask epilogues,
four launches forward and two backward. At the slice shape (64, 784, 512,
256) the operations bound is 2 µs a direction, but with 64 rows a product
the time is set by each CTA's chain of launch, depth stages and epilogue.
:func:`plan` keeps that chain short: for each product a 64-row output tile
16 or 32 columns wide and a split of the depth over a thread block cluster
of up to 8 CTAs that add their partial tiles in rank order, so each product
runs 128-392 CTAs on the 132 SMs; the backward pairs its two
independent products of each step into one launch, and the launches after
the first may start early and prefetch their weights (programmatic
dependent launch, ``PDL``).

Layouts are torch's: x is the (B, N0) flattened interpolates in
``img.view(B, -1)`` order, and the weights are ``nn.Linear``'s (out, in):
w1 (N1, N0), w2 (N2, N1), w3 (1, N2). The forward keeps u and t for the
backward, which computes the same function as recomputing them.

Outside the kernels, as in JAX: the per-sample norm and P = mean((|g|-1)^2)
with torch's norm-at-0 subgradient, and q = dP/dg (``_norm_penalty`` :75,
``_q_from`` :84), in plain torch ops.

Dispatch is by device and nothing else: a CPU tensor takes the plain version,
a CUDA tensor launches the kernels or raises. The counters ``gp.fwd`` and
``gp.bwd`` of ``tpugan_torch.utils.tracing.counts`` count wrapper calls
that launched, and only those; ``gp.fwd.captured`` and ``gp.bwd.captured``
count those of them made while the current stream was capturing a CUDA
graph. A captured call counts once however often its graph is replayed: the
kernels that ran on the device are the calls not captured plus each
captured call times its graph's replays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from tpugan_torch.ops._build import GpPlan, GpProduct, check_tensors, library
from tpugan_torch.utils import tracing

SLOPE = 0.2  # LeakyReLU slope of the critic (wgan/wgan.py:70)

# The launch plan's constants (``mlp_gp.cu`` holds the same). The H100
# measurements that set them are in PERF.md (``scripts/sweep_gp_plan.py``).
BM = 64  # output rows a tile
BK = 16  # depth a pipeline stage
STAGES = 2  # the cp.async ring
CLUSTER_MAX = 8  # the portable thread block cluster size
CTAS_MIN = 256  # the least CTAs a split product should run before narrower tiles
STAGES_MIN = 2  # the least depth stages a rank is given
TILE_WIDTHS = (32, 16)  # tile columns a split product may take, widest first
# The launches after the first go out as programmatic dependent launches:
# 3-5% faster each way than plain stream order on the H100 (PERF.md).
PDL = True


class Product(NamedTuple):
    """One product of a launch: C (m, n) from depth k (``mlp_gp.cu``'s Job).
    CTA i is rank i % ks of the cluster for tile i // ks; tile t covers
    columns (t % tiles_n) * bn and rows (t // tiles_n) * 64, or, for the
    column sum, every row tile in turn. Rank r sums depth [r kc, (r + 1) kc)
    and adds the ranks' partials of tile rows [r rows, (r + 1) rows); for
    the column sum it adds those rows into a column partial, and rank 0 the
    ranks' column partials in rank order."""

    name: str
    m: int
    n: int
    k: int
    bn: int  # tile columns
    ks: int  # cluster size: CTAs splitting the depth
    kc: int  # depth a rank, a multiple of BK
    rows: int  # tile rows a rank adds up and stores
    tiles_m: int  # row tiles of the grid (1 for the column sum, which loops)
    tiles_n: int  # column tiles
    ctas: int
    colsum: bool


class Plan(NamedTuple):
    """Both directions' launches: forward launch i runs products[i];
    backward launch i runs products[2i] and products[2i + 1]."""

    direction: str
    shape: tuple  # (B, N0, N1, N2)
    products: tuple
    bn: tuple  # tile columns a launch
    grid: tuple  # CTAs a launch
    smem: tuple  # dynamic shared memory a launch, bytes
    pdl: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bn: int) -> int:
    """A launch's dynamic shared memory: the ring of A and B stages, each
    row padded by 4 floats, and the (64, bn) partial tile."""
    b_tile = max(bn * (BK + 4), BK * (bn + 4))
    return 4 * (STAGES * (BM * (BK + 4) + b_tile) + BM * bn)


def _split(name: str, m: int, n: int, k: int, colsum: bool = False) -> Product:
    """A product whose depth is a feature width, split over a cluster: the
    widest of TILE_WIDTHS that reaches CTAS_MIN CTAs, else the narrowest;
    ks as large as CLUSTER_MAX allows while each rank keeps STAGES_MIN depth
    stages, then evened out so that no rank is empty."""
    stages = _cdiv(k, BK)
    per = _cdiv(stages, max(1, min(CLUSTER_MAX, stages // STAGES_MIN)))
    ks = _cdiv(stages, per)
    tiles_m = 1 if colsum else _cdiv(m, BM)
    for bn in TILE_WIDTHS:
        tiles_n = _cdiv(n, bn)
        if tiles_m * tiles_n * ks >= CTAS_MIN:
            break
    return Product(name, m, n, k, bn, ks, per * BK, _cdiv(BM, ks), tiles_m, tiles_n,
                   ks * tiles_m * tiles_n, colsum)


def _whole(name: str, m: int, n: int, k: int, bn: int) -> Product:
    """A product whose depth is the batch: no split, tiles of ``bn``."""
    tiles_m, tiles_n = _cdiv(m, BM), _cdiv(n, bn)
    return Product(name, m, n, k, bn, 1, _cdiv(k, BK) * BK, BM, tiles_m, tiles_n,
                   tiles_m * tiles_n, False)


@functools.lru_cache(maxsize=256)
def plan(b: int, n0: int, n1: int, n2: int, direction: str, pdl: bool = True) -> Plan:
    """The launch plan of one direction at x (b, n0), w1 (n1, n0), w2 (n2, n1).

    Forward, one launch each: z1 = x W1^T, z2 = a1 W2^T, t = u W2, g = t W1.
    Backward: s = q W1^T beside dW1 = t^T q, then dw3 (s W2^T, summed over
    the batch) beside dW2 = u^T s; the second product of a launch takes the
    first's tile width and runs on whole clusters of CTAs after it."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction {direction!r}, expected 'fwd' or 'bwd'")
    if min(b, n0, n1, n2) <= 0:
        raise ValueError(f"no work: shape {(b, n0, n1, n2)}")
    if direction == "fwd":
        prods = (_split("z1", b, n1, n0), _split("z2", b, n2, n1), _split("t", b, n1, n2),
                 _split("g", b, n0, n1))
        launches = [(p, None) for p in prods]
    else:
        s = _split("s", b, n1, n0)
        dw1 = _whole("dw1", n1, n0, b, s.bn)
        dw3 = _split("dw3", b, n2, n1, colsum=True)
        dw2 = _whole("dw2", n2, n1, b, dw3.bn)
        prods = (s, dw1, dw3, dw2)
        launches = [(s, dw1), (dw3, dw2)]
    grid = tuple(p0.ctas + (0 if p1 is None else _cdiv(p1.ctas, p0.ks) * p0.ks)
                 for p0, p1 in launches)
    bns = tuple(p0.bn for p0, _ in launches)
    return Plan(direction, (b, n0, n1, n2), prods, bns, grid, tuple(smem_bytes(bn) for bn in bns),
                pdl)


def _c_plan(p: Plan) -> GpPlan:
    c = GpPlan(*p.shape, int(p.pdl))
    for i, (bn, grid, smem) in enumerate(zip(p.bn, p.grid, p.smem)):
        c.bn[i], c.grid[i], c.smem[i] = bn, grid, smem
    for i, q in enumerate(p.products):
        c.prod[i] = GpProduct(q.ks, q.kc, q.rows, q.tiles_m, q.tiles_n, q.ctas)
    return c


@functools.lru_cache(maxsize=256)
def _plan_arg(b: int, n0: int, n1: int, n2: int, direction: str, pdl: bool):
    """The plan for a launch and the C struct ctypes passes for it (kept
    alive by the cache)."""
    p = plan(b, n0, n1, n2, direction, pdl)
    c = _c_plan(p)
    return p, c, ctypes.byref(c)


def _mask(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z.new_tensor(1.0), z.new_tensor(SLOPE))


def mlp_gp_fwd_ref(x, w1, b1, w2, b2, w3, masks=None):
    """Plain version of the forward kernel: (g, m1, m2, u, t). ``masks``
    = (m1, m2) replaces the masks computed from the pre-activations (the
    card's parity check uses it where a pre-activation sits within rounding
    of 0)."""
    z1 = x @ w1.T + b1
    m1 = _mask(z1) if masks is None else masks[0]
    z2 = (z1 * m1) @ w2.T + b2
    m2 = _mask(z2) if masks is None else masks[1]
    u = m2 * w3.reshape(1, -1)
    t = (u @ w2) * m1
    return t @ w1, m1, m2, u, t


def mlp_gp_bwd_ref(q, m1, m2, w1, w2, u, t):
    """Plain version of the backward kernel: (dw1, dw2, dw3) in the weights'
    layouts, dw3 as (1, N2)."""
    s = (q @ w1.T) * m1
    dw1 = t.T @ q
    dw2 = u.T @ s
    dw3 = (m2 * (s @ w2.T)).sum(dim=0, keepdim=True)
    return dw1, dw2, dw3


def _shapes(x, w1, w2):
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 or x.numel() == 0:
        raise ValueError(
            f"mlp_gp: expected x (B, N0), w1 (N1, N0), w2 (N2, N1); got "
            f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}"
        )
    (b, n0), n1, n2 = x.shape, w1.shape[0], w2.shape[0]
    if w1.shape[1] != n0 or w2.shape[1] != n1:
        raise ValueError(f"mlp_gp: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do not chain "
                         f"from x {tuple(x.shape)}")
    return b, n0, n1, n2


def _raise_on(rc: int, name: str, p: Plan) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch; {p}")


# The C entry points, the raw-stream reader and the capture query
# (``torch.cuda.is_current_stream_capturing`` without its checks), bound at
# the first launch.
_bound: Optional[tuple] = None


def _bind():
    global _bound
    lib = library()
    # The value of torch.cuda.current_stream(index).cuda_stream, without
    # building a Stream object (CUDA builds of torch only); read at every
    # launch, since a CUDA-graph capture swaps it.
    _bound = (lib.mlp_gp_fwd, lib.mlp_gp_bwd, torch._C._cuda_getCurrentRawStream,
              torch._C._cuda_isCurrentStreamCapturing)
    return _bound


def _launch_fwd(x, w1, b1, w2, b2, w3):
    """Checks CUDA inputs and launches the forward of ``mlp_gp.cu``:
    (g, m1, m2, u, t)."""
    dev = x.get_device()
    check_tensors("mlp_gp_fwd", dev, x, w1, b1, w2, b2, w3)
    b, n0, n1, n2 = _shapes(x, w1, w2)
    if b1.shape != (n1,) or b2.shape != (n2,) or w3.numel() != n2:
        raise ValueError(f"mlp_gp_fwd: b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}, "
                         f"w3 {tuple(w3.shape)} do not fit N1 {n1}, N2 {n2}")
    p, _, cp = _plan_arg(b, n0, n1, n2, "fwd", PDL)
    fwd, _, stream, _ = _bound or _bind()
    g, m1, t = x.new_empty((b, n0)), x.new_empty((b, n1)), x.new_empty((b, n1))
    m2, u = x.new_empty((b, n2)), x.new_empty((b, n2))
    rc = fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             w3.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(), u.data_ptr(),
             t.data_ptr(), cp, stream(dev))
    _raise_on(rc, "mlp_gp_fwd", p)
    return g, m1, m2, u, t


def _launch_bwd(q, m1, m2, w1, w2, u, t):
    """Checks CUDA inputs and launches the backward of ``mlp_gp.cu``:
    (dw1, dw2, dw3)."""
    dev = q.get_device()
    check_tensors("mlp_gp_bwd", dev, q, m1, m2, w1, w2, u, t)
    b, n0, n1, n2 = _shapes(q, w1, w2)
    if m1.shape != (b, n1) or t.shape != (b, n1) or m2.shape != (b, n2) or u.shape != (b, n2):
        raise ValueError(
            f"mlp_gp_bwd: m1 {tuple(m1.shape)}, t {tuple(t.shape)}, m2 {tuple(m2.shape)}, "
            f"u {tuple(u.shape)} do not fit B {b}, N1 {n1}, N2 {n2}"
        )
    p, _, cp = _plan_arg(b, n0, n1, n2, "bwd", PDL)
    _, bwd, stream, _ = _bound or _bind()
    dw1, dw2, dw3, s = q.new_empty((n1, n0)), q.new_empty((n2, n1)), q.new_empty((1, n2)), \
        q.new_empty((b, n1))
    rc = bwd(q.data_ptr(), m1.data_ptr(), m2.data_ptr(), w1.data_ptr(), w2.data_ptr(),
             u.data_ptr(), t.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dw3.data_ptr(),
             s.data_ptr(), cp, stream(dev))
    _raise_on(rc, "mlp_gp_bwd", p)
    return dw1, dw2, dw3


def mlp_gp_fwd(x, w1, b1, w2, b2, w3):
    """Forward wrapper: (g, m1, m2, u, t). CPU tensors take the plain
    version; CUDA tensors launch ``mlp_gp_fwd`` of ``mlp_gp.cu``."""
    if x.is_cpu:
        return mlp_gp_fwd_ref(x, w1, b1, w2, b2, w3)
    out = _launch_fwd(x, w1, b1, w2, b2, w3)
    tracing.count("gp.fwd")
    tracing.count("gp.fwd.captured", _bound[3]())
    return out


def mlp_gp_bwd(q, m1, m2, w1, w2, u, t):
    """Backward wrapper: (dw1, dw2, dw3). CPU tensors take the plain
    version; CUDA tensors launch ``mlp_gp_bwd`` of ``mlp_gp.cu``."""
    if q.is_cpu:
        return mlp_gp_bwd_ref(q, m1, m2, w1, w2, u, t)
    out = _launch_bwd(q, m1, m2, w1, w2, u, t)
    tracing.count("gp.bwd")
    tracing.count("gp.bwd.captured", _bound[3]())
    return out


def norm_penalty(g: torch.Tensor):
    """(mean((|g| - 1)^2), |g|) per row, with the norm's subgradient 0 at 0
    (``pallas_critic.py:_norm_penalty``)."""
    sq = (g * g).sum(dim=1)
    nonzero = sq > 0
    n = torch.where(nonzero, torch.sqrt(torch.where(nonzero, sq, 1.0)), 0.0)
    return ((n - 1.0) ** 2).mean(), n


def q_from(g: torch.Tensor, n: torch.Tensor, ct) -> torch.Tensor:
    """dP/dg times the upstream cotangent: (2/B)(n-1)/n * g, 0 where n = 0
    (``pallas_critic.py:_q_from``)."""
    nonzero = n > 0
    coef = torch.where(nonzero, (n - 1.0) / torch.where(nonzero, n, 1.0), 0.0)
    return (ct * 2.0 / g.shape[0]) * coef[:, None] * g


class MLPGradPenalty(torch.autograd.Function):
    """P = mean((|dD/dx| - 1)^2) of the template-A critic at x, with the
    kernel pair as forward and backward. Gradients flow to w1, w2 and w3
    only: those of x, b1 and b2 are exactly 0, and are returned as None."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3):
        g, m1, m2, u, t = mlp_gp_fwd(x, w1, b1, w2, b2, w3)
        p, n = norm_penalty(g)
        ctx.save_for_backward(g, n, m1, m2, w1, w2, u, t)
        ctx.w3_shape = w3.shape
        return p

    @staticmethod
    def backward(ctx, ct):
        g, n, m1, m2, w1, w2, u, t = ctx.saved_tensors
        q = q_from(g, n, ct).contiguous()
        dw1, dw2, dw3 = mlp_gp_bwd(q, m1, m2, w1, w2, u, t)
        return None, dw1, None, dw2, None, dw3.reshape(ctx.w3_shape)


def mlp_grad_penalty(x, w1, b1, w2, b2, w3) -> torch.Tensor:
    return MLPGradPenalty.apply(x, w1, b1, w2, b2, w3)


def extract_mlp_critic(module: nn.Module):
    """(w1, b1, w2, b2, w3) when ``module`` is exactly the template-A critic
    (``MLPDiscriminator(sigmoid=False)`` with two hidden layers and float32
    parameters), else None (``pallas_critic.py:57-72``). b3 is left out: the
    penalty does not depend on it."""
    from tpugan_torch.nn.blocks import MLPDiscriminator

    if type(module) is not MLPDiscriminator or module.sigmoid or len(module.model) != 5:
        return None
    l1, l2, l3 = module.model[0], module.model[2], module.model[4]
    params = (l1.weight, l1.bias, l2.weight, l2.bias, l3.weight)
    if any(p.dtype != torch.float32 for p in params):
        return None
    return params
