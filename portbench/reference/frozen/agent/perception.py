"""Ego perception: traffic lights, obstacles, off-road — dense math over the
fleet (port of ``cilrs_tpu/agent/perception.py``).

Reproduces the reference's three per-frame checks:
 - traffic light gating by distance <= 15 m AND heading alignment >= 0.3,
   lane-aware (behind the stop line, within a lane width);
 - obstacle distance with range (0.5, 20] m, forward dot > 0.5,
   |lateral| <= 2.5 m, over vehicles AND walkers;
 - off-road when > 3.5 m from the nearest waypoint.
Every function takes the fleet: positions [E, 2], yaws [E], light states [E, L].
The thresholds come from ``cfg`` (``config.ObstacleConfig``,
``config.TrafficLightConfig``; ``configs/weather.json`` through their loaders),
with the JAX package's defaults.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.config import ObstacleConfig, TrafficLightConfig
from portbench.reference.frozen.core.geometry import const, heading_vec
from portbench.reference.frozen.core.state import WorldState
from portbench.reference.frozen.maps.network import LIGHT_NONE, LIGHT_RED, RoadNetwork
from portbench.reference.frozen.maps.queries import OFF_ROAD_DIST, nearest_waypoint

NO_OBSTACLE = 999.0
RED_AHEAD_DIST = 40.0  # m — queue-aware red-light lookahead
PREDICT_HORIZONS = (0.0, 0.6, 1.2)  # s — crossing-traffic anticipation


def _approach(net: RoadNetwork, pos: torch.Tensor, yaw: torch.Tensor):
    """(dist, align, lon, lat) of every light [E, L] relative to each ego."""
    fwd = heading_vec(yaw)  # [E, 2]
    to_light = net.light_xy - pos[:, None]  # [E, L, 2]
    approach_fwd = heading_vec(net.light_yaw)  # [L, 2]
    align = torch.sum(fwd[:, None] * approach_fwd, dim=-1)  # same-direction approach
    lon = -(to_light[..., 0] * approach_fwd[:, 0] + to_light[..., 1] * approach_fwd[:, 1])
    lat = (to_light[..., 0] * approach_fwd[:, 1] - to_light[..., 1] * approach_fwd[:, 0]).abs()
    return to_light, align, lon, lat


def check_traffic_light(
    net: RoadNetwork,
    light_state: torch.Tensor,  # [E, L]
    pos: torch.Tensor,  # [E, 2]
    yaw: torch.Tensor,  # [E]
    cfg: TrafficLightConfig = TrafficLightConfig(),
):
    """State (0 G / 1 Y / 2 R / 3 NONE) of each ego's governing light and its
    index (-1 none), both [E] int64.

    Lane-based gating (CARLA's is_at_traffic_light is lane-aware): the ego
    must be on the light's approach lane, behind its stop line up to the obey
    distance (at most 1 m past) and within a lane width laterally.
    """
    E = pos.shape[0]
    if net.num_lights == 0:
        none = torch.full((E,), LIGHT_NONE, dtype=torch.int64, device=pos.device)
        return none, torch.full_like(none, -1)
    to_light, align, lon, lat = _approach(net, pos, yaw)
    dist = torch.sqrt(torch.sum(to_light * to_light, dim=-1) + 1e-9)
    relevant = (
        (lon >= -cfg.max_obey_distance_m) & (lon <= 1.0)
        & (lat <= 3.0)
        & (align >= cfg.heading_dot_threshold)
    )
    d = torch.where(relevant, dist, torch.inf)
    idx = torch.argmin(d, dim=1, keepdim=True)
    found = torch.isfinite(torch.gather(d, 1, idx))[:, 0]
    idx = idx[:, 0]
    state = torch.where(found, torch.gather(light_state, 1, idx[:, None])[:, 0], LIGHT_NONE)
    return state, torch.where(found, idx, -1)


def red_light_ahead(
    net: RoadNetwork,
    light_state: torch.Tensor,  # [E, L]
    pos: torch.Tensor,  # [E, 2]
    yaw: torch.Tensor,  # [E]
    cfg: TrafficLightConfig = TrafficLightConfig(),
) -> torch.Tensor:
    """[E] True if the ego lane's next light within RED_AHEAD_DIST ahead is
    RED: is the queue it is in light-bound (the drive mode's escalation hold)."""
    if net.num_lights == 0:
        return torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    _, align, lon, lat = _approach(net, pos, yaw)
    relevant = (
        (lon >= -RED_AHEAD_DIST) & (lon <= 1.0)
        & (lat <= 3.0)
        & (align >= cfg.heading_dot_threshold)
    )
    return (relevant & (light_state == LIGHT_RED)).any(dim=1)


def get_obstacle_distance(
    world: WorldState,
    cfg: ObstacleConfig = ObstacleConfig(),
    horizons: tuple = PREDICT_HORIZONS,
) -> torch.Tensor:
    """[E] distance to the nearest actor in each ego's forward corridor (else
    999), tested at the given prediction horizons (positions extrapolated by
    current velocity). The teacher's labels use horizons=(0.0,) only: what a
    single frame shows."""
    pos, yaw = world.ego_pos, world.ego_yaw
    fwd = heading_vec(yaw)  # [E, 2]
    ego_vel = fwd * world.ego_speed[:, None]

    ts = const(tuple(float(h) for h in horizons), torch.float32, pos.device)[None, :, None, None]

    def corridor_min(actor_pos, actor_vel, alive) -> torch.Tensor:
        # Every horizon stacked on one axis: [E, T, A, 2].
        rel = (actor_pos[:, None] + actor_vel[:, None] * ts) \
            - (pos[:, None, None] + ego_vel[:, None, None] * ts)
        dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-9)  # [E, T, A]
        dirn = rel / torch.clamp(dist[..., None], min=1e-6)
        f = fwd[:, None, None]
        fdot = torch.sum(dirn * f, dim=-1)
        lateral = rel[..., 1] * f[..., 0] - rel[..., 0] * f[..., 1]  # cross(fwd, rel)
        ok = (
            alive[:, None]
            & (dist > cfg.min_detection_range_m)
            & (dist <= cfg.max_detection_range_m)
            & (fdot > cfg.forward_dot_threshold)
            & (lateral.abs() <= cfg.lateral_threshold_m)
        )
        return torch.where(ok, dist, NO_OBSTACLE).flatten(1).amin(dim=1)

    veh_vel = heading_vec(world.veh_yaw[:, 1:]) * world.veh_speed[:, 1:, None]
    ped_vel = heading_vec(world.ped_yaw) * world.ped_speed[..., None]
    d_veh = corridor_min(world.veh_pos[:, 1:], veh_vel, world.veh_alive[:, 1:])
    d_ped = corridor_min(world.ped_pos, ped_vel, world.ped_alive)
    return torch.minimum(d_veh, d_ped)


def ego_off_road(net: RoadNetwork, pos: torch.Tensor) -> torch.Tensor:
    # ALL waypoints including junction connectors: CARLA's Driving-lane
    # projection covers junction lanes too.
    _, dist = nearest_waypoint(net, pos)
    return dist > OFF_ROAD_DIST
