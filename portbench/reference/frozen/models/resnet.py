"""ResNet-34 visual encoder (port of ``cilrs_tpu/models/resnet.py``).

Laid out as the reference's torchvision trunk inside ``nn.Sequential``
(slots 0 conv1, 1 bn1, 2 relu, 3 maxpool, 4..7 layer1..layer4, 8 avgpool,
9 flatten), so a reference checkpoint's ``visual_encoder.N`` names load as they
are, for any ``stage_sizes``. Input is NCHW, best in ``channels_last``.

Against the Flax trunk: BatchNorm eps 1e-5 and Flax momentum 0.9 is torch
momentum 0.1, and in train mode the running variance takes the biased batch
variance, as Flax's does (``FlaxBatchNorm2d``). Flax pads the stride-2 1x1
downsample conv with SAME, which for a 1x1 kernel pads nothing, the same as
torch's padding=0 (at 88x200 the maps go 44x100 -> 22x50 -> 11x25 -> 6x13 ->
3x7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """The train-mode input is the rows ``rows`` of a batch of ``size`` rows
    that other processes hold the rest of; ``sum`` sums a tensor over those
    processes, differentiably. (``models.cilrs.global_batch`` hands it to
    the modules that read it.)"""

    size: int
    rows: slice
    sum: Callable[[torch.Tensor], torch.Tensor]


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode running variance follows Flax.

    Both normalize a batch by its biased variance v, but torch moves
    ``running_var`` towards the unbiased n/(n-1) v (n = batch x H x W) and
    Flax towards v. Torch's update goes to a copy, rv' = (1-m) rv + m v
    n/(n-1), from which the Flax value (1-m) rv + m v is rv' (n-1)/n +
    rv (1-m)/n. (The copy is what autograd saves, so the buffer itself may
    change in place.) Eval mode is BatchNorm2d's.

    With ``global_batch`` set, train mode normalizes by the statistics of
    the global batch, as a global-batch ``jit`` does in JAX: the per-channel
    sums of x and x^2 go through ``global_batch.sum`` in one call, and the
    variance is Flax's, E[x^2] - E[x]^2."""

    global_batch: GlobalBatch | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        if self.global_batch is not None:
            return self._forward_global(x)
        unbiased = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, unbiased, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_((1 - self.momentum) / n).add_(unbiased, alpha=(n - 1) / n)
        return y

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        gb = self.global_batch
        c = x.shape[1]
        xf = x.float()
        sums = gb.sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]))
        n = gb.size * x.shape[2] * x.shape[3]
        mean = sums[:c] / n
        var = sums[c:] / n - mean * mean
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def _bn(c: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=0.1)


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
