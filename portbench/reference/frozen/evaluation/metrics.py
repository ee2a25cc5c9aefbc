"""Driving metrics accumulated inside the rollout (port of
``cilrs_tpu/evaluation/metrics.py``), one accumulator per env.

Distance/time/speed accumulation, steering jerk, off-road frames, collisions
by actor type with the reference's 3 s per-type cooldown, red-light stops and
violations, route counters. The scoring formulas are in
``evaluation/scoring.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.frozen.core.state import TensorTree

COOLDOWN_S = 3.0
COL_VEHICLE, COL_WALKER, COL_OTHER = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Metrics(TensorTree):
    total_distance: torch.Tensor  # [E] m
    total_time: torch.Tensor  # [E] s
    total_frames: torch.Tensor
    speed_sum: torch.Tensor  # km/h accumulated
    speed_max: torch.Tensor  # km/h
    jerk_sum: torch.Tensor  # sum |d steer|
    last_steer: torch.Tensor
    off_road_frames: torch.Tensor
    collisions: torch.Tensor  # [E, 3] per-type counts (vehicle, walker, other)
    collision_cooldown_until: torch.Tensor  # [E, 3] sim time
    red_light_stops: torch.Tensor
    red_light_violations: torch.Tensor
    routes_completed: torch.Tensor
    routes_attempted: torch.Tensor
    obstacle_brakes: torch.Tensor
    teleports: torch.Tensor
    recoveries: torch.Tensor


def init_metrics(num_envs: int, device="cpu") -> Metrics:
    z = lambda: torch.zeros(num_envs, dtype=torch.float32, device=device)
    return Metrics(
        total_distance=z(), total_time=z(), total_frames=z(),
        speed_sum=z(), speed_max=z(), jerk_sum=z(), last_steer=z(),
        off_road_frames=z(),
        collisions=torch.zeros((num_envs, 3), dtype=torch.float32, device=device),
        collision_cooldown_until=torch.full((num_envs, 3), -1.0, dtype=torch.float32,
                                            device=device),
        red_light_stops=z(), red_light_violations=z(),
        routes_completed=z(), routes_attempted=torch.ones(num_envs, device=device),
        obstacle_brakes=z(), teleports=z(), recoveries=z(),
    )


def update_metrics(
    m: Metrics,
    speed_kmh: torch.Tensor,
    steer: torch.Tensor,
    on_road: torch.Tensor,
    dt: float,
    now: torch.Tensor,
    hit_vehicle: torch.Tensor,
    hit_walker: torch.Tensor,
    red_light_stop: torch.Tensor,
    red_light_violation: torch.Tensor,
    obstacle_brake: torch.Tensor,
    route_completed: torch.Tensor,
    route_attempted: torch.Tensor,
    teleported: torch.Tensor,
    recovered: torch.Tensor,
) -> Metrics:
    """Per-tick accumulation (reference update(), + event counters); every
    argument is [E] (dt a Python float)."""
    jerk = (steer - m.last_steer).abs()

    hits = torch.stack([hit_vehicle, hit_walker, torch.zeros_like(hit_vehicle)], dim=1)
    off_cd = now[:, None] > m.collision_cooldown_until
    counted = hits & off_cd
    collisions = m.collisions + counted.to(torch.float32)
    cooldown = torch.where(counted, now[:, None] + COOLDOWN_S, m.collision_cooldown_until)

    f = lambda b: b.to(torch.float32)
    return Metrics(
        total_distance=m.total_distance + speed_kmh * dt / 3.6,
        total_time=m.total_time + dt,
        total_frames=m.total_frames + 1.0,
        speed_sum=m.speed_sum + speed_kmh,
        speed_max=torch.maximum(m.speed_max, speed_kmh),
        jerk_sum=m.jerk_sum + jerk,
        last_steer=steer,
        off_road_frames=m.off_road_frames + f(~on_road),
        collisions=collisions,
        collision_cooldown_until=cooldown,
        red_light_stops=m.red_light_stops + f(red_light_stop),
        red_light_violations=m.red_light_violations + f(red_light_violation),
        routes_completed=m.routes_completed + f(route_completed),
        routes_attempted=m.routes_attempted + f(route_attempted),
        obstacle_brakes=m.obstacle_brakes + f(obstacle_brake),
        teleports=m.teleports + f(teleported),
        recoveries=m.recoveries + f(recovered),
    )
