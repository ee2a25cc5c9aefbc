"""Temporal control smoothing as fixed-size ring buffers (port of
``cilrs_tpu/ops/filters.py``), one buffer per env.

Reproduces the reference's smoothing (model/autonomous_drive.py:925-938):
 - steering: 5-frame weighted moving average, weights [0.1, 0.15, 0.2, 0.25,
   0.3] (recency-biased), normalized over however many frames are present;
 - throttle: plain mean over the last 5 frames.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.frozen.core.geometry import const
from portbench.reference.frozen.core.state import TensorTree

STEER_WEIGHTS = (0.1, 0.15, 0.2, 0.25, 0.3)
WINDOW = 5


@dataclasses.dataclass(frozen=True)
class SmoothingState(TensorTree):
    steer_buf: torch.Tensor  # [E, 5] oldest..newest
    throttle_buf: torch.Tensor  # [E, 5]
    count: torch.Tensor  # [E] int64 — frames seen (saturates at 5)


def init_smoothing(num_envs: int, device="cpu") -> SmoothingState:
    return SmoothingState(
        steer_buf=torch.zeros((num_envs, WINDOW), dtype=torch.float32, device=device),
        throttle_buf=torch.zeros((num_envs, WINDOW), dtype=torch.float32, device=device),
        count=torch.zeros(num_envs, dtype=torch.int64, device=device),
    )


def reset_smoothing(state: SmoothingState) -> SmoothingState:
    """Clear histories (the reference clears its deques on teleport)."""
    return init_smoothing(state.count.shape[0], state.count.device)


def smooth_controls(state: SmoothingState, steer: torch.Tensor, throttle: torch.Tensor):
    """Push raw (steer, throttle) [E]; return (state', smoothed steer, smoothed throttle)."""
    steer_buf = torch.cat([state.steer_buf[:, 1:], steer[:, None]], dim=1)
    throttle_buf = torch.cat([state.throttle_buf[:, 1:], throttle[:, None]], dim=1)
    count = torch.clamp(state.count + 1, max=WINDOW)

    # Active-slot mask: newest `count` entries of the buffer.
    slot = torch.arange(WINDOW, device=steer.device)
    active = slot >= (WINDOW - count)[:, None]

    w = torch.where(active, const(STEER_WEIGHTS, torch.float32, steer.device), 0.0)
    sm_steer = torch.sum(steer_buf * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-6)

    m = active.to(torch.float32)
    sm_throttle = torch.sum(throttle_buf * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)

    return (SmoothingState(steer_buf=steer_buf, throttle_buf=throttle_buf, count=count),
            sm_steer, sm_throttle)
