"""Evaluation step (port of ``cilrs_tpu/train/steps.py:make_eval_step``).

u8 -> float32, /255 and ImageNet normalize in plain torch, then the CILRS
forward in eval mode, the loss parts, per-command |steer error| sums and
counts, and ``pred`` = [steer, throttle, brake, pred_speed]. The train step
comes with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cilrs_tpu_torch.config import TrainConfig
from cilrs_tpu_torch.models.losses import cilrs_loss
from cilrs_tpu_torch.ops.image import normalize


def _prep_images(images_u8: torch.Tensor) -> torch.Tensor:
    return normalize(images_u8.float() / 255.0)


def make_eval_step(cfg: TrainConfig):
    loss_cfg = cfg.loss

    @torch.inference_mode()
    def eval_step(model: torch.nn.Module, batch: dict) -> dict:
        """batch: images [B,H,W,3] u8, speed [B], command [B], controls [B,3],
        all on the model's device; ``model`` is in eval mode."""
        x = _prep_images(batch["images"])
        controls, pred_speed = model(x, batch["speed"], batch["command"])
        _, parts = cilrs_loss(controls, pred_speed, batch["controls"], batch["speed"], loss_cfg)
        steer_err = (controls[:, 0] - batch["controls"][:, 0]).abs()
        onehot = F.one_hot(batch["command"].long(), 4).float()
        parts = dict(parts)
        parts["cmd_steer_err_sum"] = onehot.T @ steer_err  # [4]
        parts["cmd_count"] = onehot.sum(dim=0)  # [4]
        parts["pred"] = torch.cat([controls, pred_speed[:, None]], dim=1)
        return parts

    return eval_step
