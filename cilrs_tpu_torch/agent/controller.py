"""Controller state of the closed loop (port of the state part of
``cilrs_tpu/agent/controller.py:37-83``).

The collect mode carries this state through every tick (the teacher sets
``waiting_for_red``; a teleport resets it), so it is here with the status and
overtake codes. The rule cascade itself, ``safety_controller`` with its
overtake/reverse machine, drives only in drive mode and comes with the drive
slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from cilrs_tpu_torch.core.state import TensorTree
from cilrs_tpu_torch.ops.filters import SmoothingState, init_smoothing

# Status codes (HUD/report strings in the JAX package's evaluation.hud).
ST_OK, ST_RED, ST_YELLOW, ST_BRAKE, ST_OVERTAKE_L, ST_OVERTAKE_R, ST_REVERSE, \
    ST_UNSTICK, ST_RECOVERY, ST_TELEPORT = range(10)

# Overtake machine states.
OV_NONE, OV_LEFT, OV_RIGHT, OV_REVERSE = 0, 1, 2, 3

T_NONE = -1.0e9  # sentinel for "timer not running"


@dataclasses.dataclass(frozen=True)
class CtrlState(TensorTree):
    """Per-env controller memory threaded through the rollout ([E] fields)."""

    smoothing: SmoothingState
    waiting_for_red: torch.Tensor  # bool
    red_clear_time: torch.Tensor  # f32 — last sim time with no red gate
    waiting_for_traffic: torch.Tensor  # bool
    traffic_wait_start: torch.Tensor  # f32 (T_NONE when idle)
    obstacle_wait_start: torch.Tensor  # f32
    stopped_start: torch.Tensor  # f32
    ov_state: torch.Tensor  # i64 — overtake machine
    ov_start: torch.Tensor  # f32 — phase timer origin


def init_ctrl_state(num_envs: int, device="cpu") -> CtrlState:
    f = lambda v: torch.full((num_envs,), v, dtype=torch.float32, device=device)
    no = torch.zeros(num_envs, dtype=torch.bool, device=device)
    return CtrlState(
        smoothing=init_smoothing(num_envs, device),
        waiting_for_red=no,
        red_clear_time=f(0.0),
        waiting_for_traffic=no,
        traffic_wait_start=f(T_NONE),
        obstacle_wait_start=f(T_NONE),
        stopped_start=f(T_NONE),
        ov_state=torch.full((num_envs,), OV_NONE, dtype=torch.int64, device=device),
        ov_start=f(T_NONE),
    )


def reset_ctrl_state(ctrl: CtrlState, now: torch.Tensor) -> CtrlState:
    """Full reset (the reference clears deques + machine state on teleport);
    now [E]."""
    fresh = init_ctrl_state(now.shape[0], now.device)
    return fresh.replace(red_clear_time=now)
