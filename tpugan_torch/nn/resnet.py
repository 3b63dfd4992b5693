"""torchvision's ResNet18 trunk, randomly initialized (``tpugan/nn/resnet.py``).

bicyclegan's encoder takes ``resnet18(pretrained=False)`` children[:-3]
(bicyclegan/models.py:102-118): conv1, bn1, relu, maxpool, layer1 (64),
layer2 (128, stride 2) and layer3 (256, stride 2), output stride 16. Built
here without torchvision, with its registration order, so the ``state_dict``
keys are the reference's (``0``, ``1``, ``4.0.conv1`` ... ``6.1.bn2``,
``5.0.downsample.0``/``.1``). Init is torchvision's: convs
``kaiming_normal_(mode="fan_out")`` without bias, BatchNorm at torch's
default (the reference leaves the encoder out of ``weights_init_normal``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpugan_torch.nn.layers import BatchNorm2d


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
    with torch.no_grad():
        nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu",
                                generator=generator)
    return conv


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: conv1, bn1, relu, conv2, bn2, and a 1x1
    conv + BatchNorm ``downsample`` where the stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, generator)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU()
        self.conv2 = _conv(planes, planes, 3, 1, 1, generator)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride, 0, generator),
                                            BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(self.relu(self.bn1(self.conv1(x)))))
        return self.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet18Trunk(nn.Sequential):
    """conv1 .. layer3 of ResNet18: (B, 3, H, W) to (B, 256, H/16, W/16)."""

    def __init__(self, in_channels: int = 3, generator: Optional[torch.Generator] = None):
        layers = [_conv(in_channels, 64, 7, 2, 3, generator), BatchNorm2d(64), nn.ReLU(),
                  nn.MaxPool2d(3, 2, 1)]
        cin = 64
        for planes, first_stride in ((64, 1), (128, 2), (256, 2)):
            layers.append(nn.Sequential(BasicBlock(cin, planes, first_stride, generator),
                                        BasicBlock(planes, planes, 1, generator)))
            cin = planes
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Its convs are raw ``nn.Conv2d``, which read no compute dtype, as
        # the JAX trunk's raw flax ``nn.Conv`` (``tpugan/nn/resnet.py:21-30``):
        # flax promotes a bf16 input to the float32 kernel's dtype, so the
        # trunk runs in float32 under --dtype bfloat16 too.
        return super().forward(x.to(torch.promote_types(x.dtype, self[0].weight.dtype)))
