"""Layers with the JAX package's semantics (``tpugan/nn/layers.py``), on NCHW.

Only what the ported trainers (``tpugan_torch/models/__init__.py``) need is
here. Init modes that no trainer uses raise ``NotImplementedError`` naming
the ROADMAP section that leaves them out.

Mixed precision (``--dtype bfloat16``) is the JAX package's: a process-wide
compute dtype (``set_default_compute_dtype``, ``tpugan/nn/layers.py:33-52``)
that ``Conv2d``, ``ConvTranspose2d`` and ``Linear`` read in ``forward``,
where they cast their input, weight and bias to it and return its dtype.
The parameters stay float32 (the master weights: the optimizers and the
checkpoints see only them), and so do norm statistics and buffers. The
casts are explicit, layer by layer, not ``torch.autocast``, so the CPU and
the card, eager and a replayed CUDA graph run the same casts as the JAX
package. A raw ``nn.Conv2d`` (the ResNet18 trunk's, as flax's raw
``nn.Conv`` there) reads no compute dtype and stays float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops.image import reflection_pad, upsample_nearest, zero_pad_lt
from tpugan_torch.ops.instance_norm import instance_norm_act
from tpugan_torch.parallel.mesh import gather_rows

_NOT_PORTED = "no trainer of the JAX package uses it (ROADMAP, Not ported)"

# None is float32; torch.bfloat16 is mixed precision.
_COMPUTE_DTYPE = [None]


def set_default_compute_dtype(dtype) -> None:
    """Set the process-wide compute dtype of Conv2d, ConvTranspose2d and
    Linear: None (float32) or torch.bfloat16. Norms keep float32
    statistics whatever it is."""
    _COMPUTE_DTYPE[0] = dtype


def resolve_dtype(dtype_str: str):
    """The compute dtype of a ``--dtype`` value: None for float32."""
    return {"float32": None, "bfloat16": torch.bfloat16}[dtype_str]


def compute_dtype():
    """The process-wide compute dtype (None: float32)."""
    return _COMPUTE_DTYPE[0]


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


# torch's own layer PixelShuffle, which the JAX package reproduces (its NHWC
# version is pinned to torch's channel order, tests/test_sr_family.py).
PixelShuffle = nn.PixelShuffle


class PReLU(nn.PReLU):
    """torch.nn.PReLU: one slope, 0.25 at init (``tpugan/nn/layers.py:
    656-664``). On a bf16 input it computes the JAX layer's
    ``where(x >= 0, x, a * x)`` with the float32 slope, which promotes the
    output to float32 there and here."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return torch.where(x >= 0, x, self.weight * x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)``: the gradient at exactly 0 is 1, as in
    JAX (``F.leaky_relu`` gives ``slope`` there)."""
    return torch.where(x >= 0, x, negative_slope * x)


def _check_init_mode(layer: str, init_mode: str, ported: tuple) -> None:
    if init_mode not in ported:
        raise NotImplementedError(f"{layer}(init_mode={init_mode!r}): {_NOT_PORTED}")


@torch.no_grad()
def _init_weight_bias(layer, init_mode: str, fan_in: int, generator) -> None:
    """``tpugan/nn/layers.py:_weight_init``/``_bias_init``: ``torch`` is
    kaiming_uniform_(a=sqrt(5)) and bias U(+-1/sqrt(fan_in)); ``normal02``
    is weight N(0, 0.02) with that same bias (the reference's
    ``weights_init_normal``, which leaves biases at torch's default);
    ``normal02zero`` is weight N(0, 0.02) and bias zero; ``he`` (the
    random-feature VGG) is weight N(0, sqrt(2 / fan_in)) with the torch
    bias. Draws come from ``generator``, so a seed fixes them."""
    if init_mode == "torch":
        nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=generator)
    elif init_mode == "he":
        layer.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    else:
        layer.weight.normal_(0.0, 0.02, generator=generator)
    if layer.bias is None:
        return
    if init_mode == "normal02zero":
        layer.bias.zero_()
    else:
        bound = 1.0 / math.sqrt(fan_in)
        layer.bias.uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Conv2d):
    """torch.nn.Conv2d with an ``init_mode`` of ``tpugan/nn/layers.py:Conv``.
    The default is ``normal02zero``, the reference cyclegan's
    ``weights_init_normal`` (cyclegan/models.py:6-14); munit's is
    ``normal02``; cogan's and the SR networks' convs keep torch's own init,
    ``torch`` (cogan/cogan.py:42-48 matches only Linear and BatchNorm); the
    VGG features' is ``he``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
        *,
        init_mode: str = "normal02zero",
        generator: Optional[torch.Generator] = None,
    ):
        _check_init_mode("Conv2d", init_mode, ("normal02zero", "normal02", "torch", "he"))
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        _init_weight_bias(self, init_mode, in_channels * kernel_size * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _COMPUTE_DTYPE[0]
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch.nn.ConvTranspose2d (``tpugan/nn/layers.py:ConvTranspose``), cuDNN's
    transposed convolution: out = (in - 1) * stride - 2 * padding + kernel.
    ``init_mode`` as ``Conv2d``'s, with torch's fan-in of a transposed
    convolution: out_channels * kernel * kernel (the weight is (in, out, k,
    k)). The default is ``normal02``, the reference's ``weights_init_normal``
    on pix2pix, dualgan, context_encoder and ccgan."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
        *,
        init_mode: str = "normal02",
        generator: Optional[torch.Generator] = None,
    ):
        _check_init_mode("ConvTranspose2d", init_mode, ("normal02zero", "normal02"))
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
        _init_weight_bias(self, init_mode, out_channels * kernel_size * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _COMPUTE_DTYPE[0]
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """torch.nn.Linear with an ``init_mode`` of ``tpugan/nn/layers.py:Linear``;
    the default is torch's own init; ``normal02zero`` is cluster_gan's
    ``initialize_weights`` (clustergan.py:106-116)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        init_mode: str = "torch",
        generator: Optional[torch.Generator] = None,
    ):
        _check_init_mode("Linear", init_mode, ("torch", "normal02", "normal02zero"))
        super().__init__(in_features, out_features, bias=bias)
        _init_weight_bias(self, init_mode, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _COMPUTE_DTYPE[0]
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


def _init_batch_norm(bn, init_mode: str, generator) -> None:
    """``tpugan/nn/layers.py:BatchNorm``'s init modes: ``torch`` is scale 1,
    bias 0; ``normal02`` (the reference's ``weights_init_normal`` on
    BatchNorm2d, dcgan/dcgan.py:36-42) is scale ~ N(1, 0.02) from
    ``generator``, bias 0."""
    if init_mode not in ("torch", "normal02"):
        raise ValueError(f"{type(bn).__name__}(init_mode={init_mode!r}): torch or normal02")
    if init_mode == "normal02":
        with torch.no_grad():
            bn.weight.normal_(1.0, 0.02, generator=generator)


def _one_value_batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Train-mode batch norm over one value a channel (a ragged tail of one
    sample through ``BatchNorm1d``, or a 1x1 map), where torch raises and the
    JAX layer (``tpugan/nn/layers.py:411-509``) normalizes: variance 0, so
    the output is ``bias`` with a zero gradient to ``x`` and ``weight``;
    the running mean moves towards the value and the running variance
    towards 0 (its unbiased factor ``n / max(n - 1, 1)`` is 1). In float32,
    rounded once to ``x``'s dtype."""
    dims = [0, *range(2, x.dim())]
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    mean = xf.mean(dims)
    centered = xf - mean.view(shape)
    var = centered.square().mean(dims)
    y = centered * torch.rsqrt(var + bn.eps).view(shape)
    if bn.affine:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean.detach(), alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var.detach(), alpha=bn.momentum)
            bn.num_batches_tracked.add_(1)
    return y.to(x.dtype)


def global_batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Train-mode batch norm over the global batch of the ranks of ``bn.dp``
    (``tpugan_torch/parallel/mesh.py``), the statistics GSPMD gives the JAX
    layer over a sharded batch. Each rank contributes its count, mean and
    sum of squared deviations a channel, gathered in one differentiable
    all-gather and combined as Chan et al.'s pairwise update (no
    cancellation between E[x^2] and E[x]^2); the output is normalized by the
    biased global variance and ``running_var`` moves by the unbiased one,
    its factor ``n / max(n - 1, 1)`` with n the global count, so one value a
    channel over all ranks gives ``_one_value_batch_norm``'s result. In
    float32, rounded once to ``x``'s dtype. The gradient flows to every
    rank's input through the gather's backward."""
    dims = [0, *range(2, x.dim())]
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    count = xf.numel() // xf.shape[1]
    mean = xf.mean(dims)
    m2 = (xf - mean.view(shape)).square().sum(dims)
    stats = gather_rows(bn.dp, torch.stack([torch.full_like(mean, count), mean, m2])[None])
    counts, means, m2s = stats.unbind(1)
    n = counts.sum(0)
    g_mean = (counts * means).sum(0) / n
    var = (m2s + counts * (means - g_mean).square()).sum(0) / n
    y = (xf - g_mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    if bn.affine:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            unbiased = var * (n / (n - 1).clamp(min=1))
            bn.running_mean.mul_(1.0 - bn.momentum).add_(g_mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(unbiased, alpha=bn.momentum)
            bn.num_batches_tracked.add_(1)
    return y.to(x.dtype)


def _batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    if bn.training and getattr(bn, "dp", None) is not None:
        return global_batch_norm(bn, x)
    if bn.training and x.numel() == x.shape[1]:
        return _one_value_batch_norm(bn, x)
    return nn.modules.batchnorm._BatchNorm.forward(bn, x)


class BatchNorm1d(nn.BatchNorm1d):
    """torch.nn.BatchNorm1d, the semantics ``tpugan/nn/layers.py:BatchNorm``
    reproduces in flax: ``eps`` passed verbatim (the reference's 0.8),
    momentum 0.1, the biased batch variance to normalize and the unbiased
    one folded into ``running_var``. ``init_mode`` as ``_init_batch_norm``.
    A bf16 input (``tpugan/nn/layers.py:455-509``) keeps the float32
    parameters and running buffers: torch's batch norm takes the mixed
    dtypes, computes float32 statistics and the normalize in float32, and
    rounds the output to bf16 once, where the JAX layer folds the normalize
    into a bf16 ``x * a + b``. One value a channel in train mode (a ragged
    tail of one sample) takes the JAX layer's result
    (``_one_value_batch_norm``), where torch raises. Under data parallelism
    (``dp``, attached by ``parallel.replicate_for``) the statistics are the
    global batch's (``global_batch_norm``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 *, init_mode: str = "torch", generator: Optional[torch.Generator] = None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        _init_batch_norm(self, init_mode, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x)


class BatchNorm2d(nn.BatchNorm2d):
    """torch.nn.BatchNorm2d with the semantics and init modes of
    ``BatchNorm1d``: statistics per channel over (N, H, W). DCGAN's generator
    passes eps 1e-5 to its first BatchNorm and 0.8 to the others."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 *, init_mode: str = "torch", generator: Optional[torch.Generator] = None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        _init_batch_norm(self, init_mode, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x)


class MaskedDropout(nn.Module):
    """Dropout through a keep mask the caller passes, drawn by ``draw_mask``
    from an explicit generator; never from the global RNG, as ``F.dropout``
    would. In training the kept elements are scaled by 1/(1-p); in eval mode
    the input passes unchanged."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def draw_mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """A float32 0/1 keep mask of ``shape``, on the generator's device."""
        keep = torch.full(shape, 1.0 - self.p, device=generator.device)
        return torch.bernoulli(keep, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            return x
        if mask is None:
            raise ValueError(f"{type(self).__name__} in training needs its keep mask (draw_mask)")
        # In x's dtype, as flax's select: the 0/1 mask is exact in bf16.
        return x / (1.0 - self.p) * mask.to(x.dtype)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class Dropout2d(MaskedDropout):
    """torch.nn.Dropout2d (``tpugan/nn/layers.py:Dropout2d``): whole channels
    are zeroed, through a (B, C, 1, 1) keep mask."""


class Dropout(MaskedDropout):
    """torch.nn.Dropout (``tpugan/nn/layers.py:Dropout``): each element is
    zeroed, through a keep mask of the input's shape."""


class Embedding(nn.Embedding):
    """torch.nn.Embedding (``tpugan/nn/layers.py:Embedding``): a
    (num_embeddings, features) table with weights N(0, 1), drawn from
    ``generator``."""

    def __init__(self, num_embeddings: int, features: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__(num_embeddings, features)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)


@contextlib.contextmanager
def batch_stats_frozen(module: nn.Module):
    """Within the block, every BatchNorm and every tracked InstanceNorm of
    ``module`` in training normalizes by its batch (or instance) statistics,
    as always, but leaves its running statistics and
    ``num_batches_tracked`` as they are: the forward whose statistics the
    JAX package throws away (DRAGAN's penalty, ``tpugan/models/dragan.py:
    99-112``; the samplers' train-mode generators, stargan's among them,
    ``tpugan/models/stargan.py:375-381``). A Python switch, so a CUDA graph
    can capture the forward."""
    norms = [m for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    tracked = [m for m in module.modules()
               if isinstance(m, InstanceNorm) and m.track_running_stats]
    for m in norms:
        m.track_running_stats = False
    for m in tracked:
        m.stats_frozen = True
    try:
        yield module
    finally:
        for m in norms:
            m.track_running_stats = True
        for m in tracked:
            m.stats_frozen = False


class InstanceNorm(nn.Module):
    """torch.nn.InstanceNorm2d with an optional fused leaky activation:
    ``act_slope`` 1.0 is plain IN, 0.0 IN+ReLU, 0.2 IN+LeakyReLU(0.2). Runs
    through the instance-norm kernel pair (``tpugan_torch/ops/instance_norm.py``).

    ``affine=True`` (dualgan, stargan) adds torch's per-channel ``weight``
    (ones) and ``bias`` (zeros) over ``num_features`` channels, applied
    outside the kernel as the JAX package applies its scale and bias
    (``tpugan/nn/layers.py:562-571``): the kernel at slope 1, then
    ``y * weight + bias``. An activation after the affine stays a layer of
    its own, so ``act_slope`` must be 1 then.

    ``track_running_stats=True`` (stargan, ``tpugan/nn/layers.py:531-556``)
    registers torch's buffers ``running_mean`` (zeros), ``running_var``
    (ones) and ``num_batches_tracked`` (0; torch's InstanceNorm2d never
    advances it), and needs act_slope 1 too. In training the kernel
    normalizes per instance as always; then, without gradients and in place
    (so a captured CUDA graph keeps the buffers), the buffers take torch's
    update with momentum 0.1: the batch mean of the per-plane means, and of
    the per-plane variances made unbiased over H*W. ``stats_frozen``
    (``batch_stats_frozen``) skips the update. In eval mode the layer
    normalizes by the buffers in plain PyTorch, ``(x - running_mean) *
    rsqrt(running_var + eps)``, as the JAX package does in plain XLA, then
    applies the affine.

    A bf16 x (``--dtype bfloat16``) takes the bf16 kernels, whose output is
    bf16; the float32 ``weight`` and ``bias`` then promote the affine's
    output to float32, as JAX's type promotion does, and so do the float32
    buffers in eval mode. The buffers stay float32."""

    MOMENTUM = 0.1  # torch's default, the reference's (stargan/models.py:23)

    def __init__(
        self,
        num_features: int = 0,
        act_slope: float = 1.0,
        eps: float = 1e-5,
        affine: bool = False,
        track_running_stats: bool = False,
    ):
        super().__init__()
        if (affine or track_running_stats) and (num_features <= 0 or act_slope != 1.0):
            raise ValueError(f"InstanceNorm(affine={affine}, track_running_stats="
                             f"{track_running_stats}) needs num_features and act_slope 1, "
                             f"got {num_features}, {act_slope}")
        self.act_slope = act_slope
        self.eps = eps
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.stats_frozen = False
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(num_features))
            self.register_buffer("running_var", torch.ones(num_features))
            self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.track_running_stats and not self.training:
            y = ((x - self.running_mean.view(1, -1, 1, 1))
                 * torch.rsqrt(self.running_var.view(1, -1, 1, 1) + self.eps))
        else:
            y = instance_norm_act(x, self.act_slope, self.eps)
            if self.track_running_stats and not self.stats_frozen:
                self._update_running_stats(x)
        if self.affine:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y

    @torch.no_grad()
    def _update_running_stats(self, x: torch.Tensor) -> None:
        var, mean = torch.var_mean(x, dim=(2, 3), correction=1)
        m = self.MOMENTUM
        self.running_mean.mul_(1.0 - m).add_(mean.mean(dim=0), alpha=m)
        self.running_var.mul_(1.0 - m).add_(var.mean(dim=0), alpha=m)

    def extra_repr(self) -> str:
        return (f"act_slope={self.act_slope}, eps={self.eps}, affine={self.affine}, "
                f"track_running_stats={self.track_running_stats}")


class LayerNormSpatial(nn.Module):
    """MUNIT's LayerNorm (``tpugan/nn/layers.py:LayerNormSpatial``,
    munit/models.py:304-324): per sample over (C, H, W), divided by the
    unbiased std plus eps (eps on the std, not the variance), then a
    per-channel affine ``gamma`` ~ U(0, 1), ``beta`` = 0, registered under
    the reference's names. A bf16 input is normalized in float32; the
    float32 affine makes the output float32, as in the JAX layer."""

    eps = 1e-5

    def __init__(self, num_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(num_features).uniform_(generator=generator))
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        flat = x.reshape(x.shape[0], -1)
        mean = flat.mean(dim=1).reshape(-1, 1, 1, 1)
        std = flat.std(dim=1).reshape(-1, 1, 1, 1)
        y = (x - mean) / (std + self.eps)
        return y * self.gamma.reshape(1, -1, 1, 1) + self.beta.reshape(1, -1, 1, 1)


class Upsample(nn.Module):
    """torch.nn.Upsample(scale_factor), nearest."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, self.scale_factor)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


class ReflectionPad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflection_pad(x, self.pad)


class ZeroPadLT(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return zero_pad_lt(x)
