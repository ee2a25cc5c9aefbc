"""ResNet-34 visual encoder (port of ``cilrs_tpu/models/resnet.py``).

Laid out as the reference's torchvision trunk inside ``nn.Sequential``
(slots 0 conv1, 1 bn1, 2 relu, 3 maxpool, 4..7 layer1..layer4, 8 avgpool,
9 flatten), so a reference checkpoint's ``visual_encoder.N`` names load as they
are, for any ``stage_sizes``. Input is NCHW, best in ``channels_last``.

Against the Flax trunk: BatchNorm eps 1e-5 and Flax momentum 0.9 is torch
momentum 0.1. Flax pads the stride-2 1x1 downsample conv with SAME, which for a
1x1 kernel pads nothing, the same as torch's padding=0 (at 88x200 the maps go
44x100 -> 22x50 -> 11x25 -> 6x13 -> 3x7).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = _bn(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = _bn(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class ResNet34(nn.Sequential):
    """ResNet trunk -> [B, stage_features[-1]] global feature."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stage_features: Sequence[int] = (64, 128, 256, 512)):
        layers = []
        cin = 64
        for stage, (num_blocks, feats) in enumerate(zip(stage_sizes, stage_features)):
            stride = 2 if stage > 0 else 1
            blocks = [BasicBlock(cin, feats, stride)]
            blocks += [BasicBlock(feats, feats) for _ in range(num_blocks - 1)]
            layers.append(nn.Sequential(*blocks))
            cin = feats
        super().__init__(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), _bn(64), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2, 1), *layers, nn.AdaptiveAvgPool2d(1), nn.Flatten())
