"""The arithmetic precision a reference runs in, and the lower precisions
that serve as the controls of the check.

- ``float32``: float32 with TF32 off, the configuration's fp32.
- ``tf32``: float32 storage with TF32 on for convolutions and matmuls, the
  control of a float32 cell.
- ``bfloat16``: each convolution and linear casts its input, weight and
  bias to bf16 and returns bf16, over float32 parameters; norms keep
  float32 statistics. The configuration's mixed precision.
- ``fp8``: as ``bfloat16``, with the input and the weight of each
  convolution and linear first rounded to float8 e4m3 (no scaling), the
  control of a bf16 cell.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")


class Precision:
    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
        self.name = name
        self.dtype = torch.bfloat16 if name in ("bfloat16", "fp8") else None

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            t = t.to(torch.float8_e4m3fn)
        return t.to(self.dtype)

    def conv2d(self, layer: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return layer(x)
        bias = None if layer.bias is None else layer.bias.to(self.dtype)
        return F.conv2d(self._operand(x), self._operand(layer.weight), bias, layer.stride,
                        layer.padding, layer.dilation, layer.groups)

    def linear(self, layer: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return layer(x)
        bias = None if layer.bias is None else layer.bias.to(self.dtype)
        return F.linear(self._operand(x), self._operand(layer.weight), bias)

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 on inside the block for ``tf32``, off for every other."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def adam(params, cfg: dict) -> torch.optim.Adam:
    """The reference's ``torch.optim.Adam(lr, (b1, b2))``."""
    return torch.optim.Adam(params, lr=cfg["lr"], betas=(cfg["b1"], cfg["b2"]))


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 to NCHW float32 in [-1, 1]: the reference's
    ``transforms.ToTensor()`` then ``Normalize([0.5], [0.5])``."""
    return (x.permute(0, 3, 1, 2).float() / 255.0 - 0.5) / 0.5
