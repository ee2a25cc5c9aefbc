"""Vehicle dynamics: kinematic bicycle model + pedestrian kinematics (port of
``cilrs_tpu/core/dynamics.py``), over every vehicle of every env at once.

Weather couples in through a friction scalar per env (grip): reduced friction
lengthens braking and caps lateral acceleration.
"""

from __future__ import annotations

import torch

from cilrs_tpu_torch.core.geometry import heading_vec, norm
from cilrs_tpu_torch.core.state import VehicleParams, WorldState
from cilrs_tpu_torch.utils.profiling import span


def bicycle_step(
    pos: torch.Tensor,  # [..., 2]
    yaw: torch.Tensor,  # [...]
    speed: torch.Tensor,  # [...] signed m/s
    steer: torch.Tensor,  # [...] in [-1, 1]
    throttle: torch.Tensor,  # [...] in [0, 1]
    brake: torch.Tensor,  # [...] in [0, 1]
    reverse: torch.Tensor,  # [...] bool
    params: VehicleParams,
    friction: torch.Tensor,  # grip multiplier in (0, 1], broadcast against [...]
    dt: float,
):
    """One integration step. Returns (pos', yaw', speed')."""
    drive_sign = torch.where(reverse, -1.0, 1.0)
    accel = drive_sign * throttle * params.max_accel * friction
    # Brake and drag oppose current motion; never flip the sign of speed.
    decel = brake * params.max_brake_decel * friction + params.drag_c0 + params.drag_c1 * speed.abs()
    new_speed = speed + dt * accel
    braked = new_speed.abs() - dt * decel
    new_speed = speed_sign_safe(new_speed) * torch.clamp(braked, min=0.0)
    # While stationary with no throttle, stay stationary (brake holds).
    new_speed = torch.where((speed.abs() < 1e-3) & (throttle < 1e-3), 0.0, new_speed)
    max_fwd = 60.0 / 3.6  # absolute powertrain cap, above the 45 km/h rule cap
    new_speed = torch.clamp(torch.maximum(new_speed, -params.max_reverse_speed), max=max_fwd)

    # Lateral grip limit: cap yaw rate so that v * yaw_rate <= friction * a_lat_max.
    delta = steer * params.max_steer_rad
    yaw_rate = new_speed / params.wheelbase * torch.tan(delta)
    a_lat_max = 9.81 * friction * 0.9
    max_yaw_rate = a_lat_max / torch.clamp(new_speed.abs(), min=1.0)
    yaw_rate = torch.minimum(torch.maximum(yaw_rate, -max_yaw_rate), max_yaw_rate)

    new_yaw = yaw + yaw_rate * dt
    new_pos = pos + heading_vec(new_yaw) * new_speed[..., None] * dt
    return new_pos, new_yaw, new_speed


def speed_sign_safe(v: torch.Tensor) -> torch.Tensor:
    """sign(v) but +1 at exactly 0 so brake math cannot create NaNs/stalls."""
    return torch.where(v < 0.0, -1.0, 1.0)


@span("physics")
def world_physics_step(
    world: WorldState,
    controls: torch.Tensor,  # [E, V, 3] (steer, throttle, brake) for ALL vehicles
    reverse: torch.Tensor,  # [E, V] bool
    params: VehicleParams,
    friction: torch.Tensor,  # [E] grip for each env's weather
    dt: float,
) -> WorldState:
    """Integrate every vehicle and pedestrian one tick. Dead actors stay frozen."""
    steer = torch.clamp(controls[..., 0], -1.0, 1.0)
    throttle = torch.clamp(controls[..., 1], 0.0, 1.0)
    brake = torch.clamp(controls[..., 2], 0.0, 1.0)

    pos, yaw, speed = bicycle_step(
        world.veh_pos, world.veh_yaw, world.veh_speed,
        steer, throttle, brake, reverse, params, friction[:, None], dt,
    )
    alive = world.veh_alive
    pos = torch.where(alive[..., None], pos, world.veh_pos)
    yaw = torch.where(alive, yaw, world.veh_yaw)
    speed = torch.where(alive, speed, 0.0)

    # Pedestrians: constant-speed walk along their heading.
    ped_pos = torch.where(
        world.ped_alive[..., None],
        world.ped_pos + heading_vec(world.ped_yaw) * world.ped_speed[..., None] * dt,
        world.ped_pos,
    )

    return world.replace(
        veh_pos=pos,
        veh_yaw=yaw,
        veh_speed=speed,
        veh_control=torch.stack([steer, throttle, brake], dim=-1),
        veh_reverse=reverse,
        ped_pos=ped_pos,
        time_s=world.time_s + dt,
        step=world.step + 1,
    )


def vehicle_circles(pos: torch.Tensor, yaw: torch.Tensor, params: VehicleParams):
    """Two-circle collision proxy per vehicle: centers [..., 2, 2] and radius.

    Circle radius = width/2 + margin; centers at +/- length/4 along heading.
    """
    h = heading_vec(yaw)
    offset = params.length / 4.0
    centers = torch.stack([pos + h * offset, pos - h * offset], dim=-2)
    radius = params.width / 2.0 + 0.1
    return centers, radius


def detect_ego_collisions(world: WorldState, params: VehicleParams):
    """Ego-vs-actor overlap test per env. Returns (hit_vehicle, hit_walker) [E]
    bools; the per-type 3 s cooldown is applied by the metrics accumulator."""
    ego_c, r = vehicle_circles(world.veh_pos[:, 0], world.veh_yaw[:, 0], params)  # [E,2,2]
    npc_c, _ = vehicle_circles(world.veh_pos[:, 1:], world.veh_yaw[:, 1:], params)  # [E,V-1,2,2]
    d = norm(ego_c[:, None, :, None, :] - npc_c[:, :, None, :, :])  # [E,V-1,2,2]
    veh_hit = ((d < 2.0 * r) & world.veh_alive[:, 1:, None, None]).flatten(1).any(dim=1)

    ped_r = 0.4
    dp = norm(ego_c[:, :, None, :] - world.ped_pos[:, None, :, :])  # [E,2,P]
    hit_walker = ((dp < (r + ped_r)) & world.ped_alive[:, None, :]).flatten(1).any(dim=1)
    return veh_hit, hit_walker
