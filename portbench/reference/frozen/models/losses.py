"""CILRS loss (port of ``cilrs_tpu/models/losses.py``):
5 * L1(steer) + 1 * L1(throttle) + 1 * L1(brake) + 0.5 * MSE(pred_speed)."""

from __future__ import annotations

import torch

from portbench.reference.frozen.config import LossConfig


def cilrs_loss(
    controls_pred: torch.Tensor,  # [B, 3]
    speed_pred: torch.Tensor,  # [B] normalized
    controls_true: torch.Tensor,  # [B, 3]
    speed_true: torch.Tensor,  # [B] normalized
    cfg: LossConfig = LossConfig(),
):
    """Returns (total_loss, dict of component losses)."""
    l1 = (controls_pred - controls_true).abs()
    steer_l = l1[:, 0].mean()
    throttle_l = l1[:, 1].mean()
    brake_l = l1[:, 2].mean()
    speed_l = ((speed_pred - speed_true) ** 2).mean()
    total = (cfg.steer_weight * steer_l + cfg.throttle_weight * throttle_l
             + cfg.brake_weight * brake_l + cfg.speed_weight * speed_l)
    return total, {
        "loss": total,
        "steer_l1": steer_l,
        "throttle_l1": throttle_l,
        "brake_l1": brake_l,
        "speed_mse": speed_l,
    }
