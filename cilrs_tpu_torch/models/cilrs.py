"""CILRS policy (port of ``cilrs_tpu/models/cilrs.py``).

ResNet-34 trunk -> 512-d visual feature; 1->128->128 speed encoder; four
command branches 640->256->256->3 (steer, throttle, brake) selected by the
command; an auxiliary 512->256->256->1 speed head off the visual feature.

Module names follow the reference's torch CILRS (``visual_encoder.N``,
``speed_encoder.{0,3}``, ``speed_predictor.{0,3,5}``,
``control_branches.k.{0,3,6}``), so a reference ``checkpoint_best.pth`` loads as
it is when ``speed_skip=False``. ``speed_skip=True`` (the default, as in the JAX
package) adds one parameter, ``speed_skip_w`` [num_commands, 3].

Numerics follow the JAX model, not the reference:
 - the trunk runs under autocast to ``dtype`` (bfloat16 by default, the JAX
   model's ``dtype``), with NCHW tensors in ``channels_last``; its feature comes
   back in float32. ``dtype=torch.float32`` turns autocast off;
 - the heads run in float32 with autocast off, except that the branch heads
   round as the JAX ``BranchHeads`` does whatever ``dtype`` is: the first layer
   multiplies bf16 inputs by bf16 weights into a bf16 product and adds its
   float32 bias; the second and third multiply float32 activations by
   bf16-rounded weights in float32;
 - the speed skip adds ``speed * speed_skip_w`` in float32, and the speed
   encoder has no dropout when it is on.

Inside ``global_batch(model, gb)`` the batch is a block of a larger batch
held by several processes, which JAX trains as one global-batch ``jit``:
BatchNorm normalizes by the global batch's statistics and dropout applies
the block's rows of the masks drawn for the global batch, so neither depends
on how the batch is split.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from cilrs_tpu_torch.models.resnet import FlaxBatchNorm2d, GlobalBatch, ResNet34

SPEED_DIM = 128
BRANCH_HIDDEN = 256
NUM_OUTPUTS = 3  # steer, throttle, brake


class BlockDropout(nn.Dropout):
    """Dropout that, with ``global_batch`` set, draws the mask of the global
    batch (``F.dropout`` of ones, the same draws as ``F.dropout`` of the
    whole batch in one process) and applies the input's rows of it."""

    global_batch: GlobalBatch | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gb = self.global_batch
        if gb is None or not self.training:
            return super().forward(x)
        mask = F.dropout(x.new_ones((gb.size,) + x.shape[1:]), self.p, True)
        return x * mask[gb.rows]


@contextlib.contextmanager
def global_batch(model: nn.Module, gb: GlobalBatch | None):
    """While the block runs, ``model``'s train-mode BatchNorm and dropout
    take its input as the rows ``gb.rows`` of a global batch (see the module
    docstring). ``gb=None`` changes nothing."""
    mods = [m for m in model.modules()
            if gb is not None and isinstance(m, (FlaxBatchNorm2d, BlockDropout))]
    for m in mods:
        m.global_batch = gb
    try:
        yield
    finally:
        for m in mods:
            m.global_batch = None


class CILRS(nn.Module):
    def __init__(self, num_commands: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 stage_sizes=(3, 4, 6, 3), stage_features=(64, 128, 256, 512),
                 speed_skip: bool = True):
        super().__init__()
        self.dtype = dtype
        self.speed_skip = speed_skip
        visual_dim = stage_features[-1]
        self.visual_encoder = ResNet34(stage_sizes, stage_features)
        self.speed_encoder = nn.Sequential(
            nn.Linear(1, SPEED_DIM), nn.ReLU(),
            nn.Identity() if speed_skip else BlockDropout(dropout),
            nn.Linear(SPEED_DIM, SPEED_DIM), nn.ReLU())
        self.control_branches = nn.ModuleList([
            nn.Sequential(
                nn.Linear(visual_dim + SPEED_DIM, BRANCH_HIDDEN), nn.ReLU(), BlockDropout(dropout),
                nn.Linear(BRANCH_HIDDEN, BRANCH_HIDDEN), nn.ReLU(), BlockDropout(dropout),
                nn.Linear(BRANCH_HIDDEN, NUM_OUTPUTS))
            for _ in range(num_commands)])
        self.speed_predictor = nn.Sequential(
            nn.Linear(visual_dim, BRANCH_HIDDEN), nn.ReLU(), BlockDropout(dropout),
            nn.Linear(BRANCH_HIDDEN, BRANCH_HIDDEN), nn.ReLU(),
            nn.Linear(BRANCH_HIDDEN, 1))
        if speed_skip:
            self.speed_skip_w = nn.Parameter(torch.zeros(num_commands, NUM_OUTPUTS))

    def _branch(self, branch: nn.Sequential, x_bf16: torch.Tensor) -> torch.Tensor:
        fc1, drop1, fc2, drop2, fc3 = branch[0], branch[2], branch[3], branch[5], branch[6]
        h = F.linear(x_bf16, fc1.weight.to(torch.bfloat16)).float() + fc1.bias
        h = drop1(F.relu(h))
        h = F.linear(h, fc2.weight.to(torch.bfloat16).float(), fc2.bias)
        h = drop2(F.relu(h))
        return F.linear(h, fc3.weight.to(torch.bfloat16).float(), fc3.bias)

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """NHWC normalized image [B,H,W,3] -> float32 visual feature [B, 512]."""
        x = image.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        with torch.autocast(image.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            return self.visual_encoder(x).float()

    def forward(self, image: torch.Tensor, speed: torch.Tensor, command: torch.Tensor):
        """image [B,H,W,3] normalized (NHWC); speed [B] normalized; command [B] int.

        Returns (controls [B,3] = steer/throttle/brake raw outputs,
                 pred_speed [B] normalized auxiliary speed), both float32.
        """
        visual = self.encode(image)
        with torch.autocast(image.device.type, enabled=False):
            s = self.speed_encoder(speed[:, None].float())
            combined = torch.cat([visual, s], dim=-1)
            pred_speed = self.speed_predictor(visual)[:, 0]
            x_bf16 = combined.to(torch.bfloat16)
            out = torch.stack([self._branch(b, x_bf16) for b in self.control_branches], dim=1)
            if self.speed_skip:
                out = out + speed[:, None, None].float() * self.speed_skip_w
            sel = command.long()[:, None, None].expand(-1, 1, NUM_OUTPUTS)
            controls = out.gather(1, sel)[:, 0]
        return controls, pred_speed
