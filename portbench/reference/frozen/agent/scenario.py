"""Scenario setup: spawn ego, NPC traffic and pedestrians on a road network
(port of ``cilrs_tpu/agent/scenario.py``).

Host-side numpy at episode boundaries. It consumes the given
``np.random.RandomState`` exactly as the JAX function does, so one seed spawns
identical worlds in both packages. It returns one env's world as numpy arrays
named as the ``WorldState`` fields; ``core.convert.world_from_arrays`` stacks
the envs' arrays into the fleet's tensors.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.frozen.maps.network import LANE_WIDTH, SIDEWALK_WIDTH, RoadNetwork

NPC_MIN_DIST_FROM_EGO = 30.0
NPC_TARGET_SPEED_KMH = 30.0 * 0.7  # TM 30% speed reduction (reference :733-736)


def spawn_world(
    net: RoadNetwork,
    num_vehicles: int,  # total incl. ego
    num_pedestrians: int,
    rng: np.random.RandomState,
    ego_spawn: int | None = None,  # spawn-point index (reference --spawn flag)
    weather_idx: int = 0,
    return_info: bool = False,
):
    h = net.host
    spawns = h.spawn_wp
    wp_xy = h.wp_xy
    wp_yaw = h.wp_yaw

    if ego_spawn is None:
        ego_spawn = int(rng.randint(len(spawns)))
    ego_wp = int(spawns[ego_spawn % len(spawns)])
    ego_pos = wp_xy[ego_wp]

    # --- ego ---
    veh_pos = np.zeros((num_vehicles, 2), np.float32)
    veh_yaw = np.zeros((num_vehicles,), np.float32)
    veh_wp = np.zeros((num_vehicles,), np.int32)
    veh_alive = np.zeros((num_vehicles,), bool)
    veh_target = np.full((num_vehicles,), NPC_TARGET_SPEED_KMH / 3.6, np.float32)
    veh_pos[0] = ego_pos
    veh_yaw[0] = wp_yaw[ego_wp]
    veh_wp[0] = ego_wp
    veh_alive[0] = True

    # --- NPC vehicles: unique spawn points, >= 30 m from ego ---
    far = np.linalg.norm(wp_xy[spawns] - ego_pos, axis=1) >= NPC_MIN_DIST_FROM_EGO
    candidates = spawns[far]
    rng.shuffle(candidates)
    n_npc = min(num_vehicles - 1, len(candidates))
    for i in range(n_npc):
        wp = int(candidates[i])
        veh_pos[i + 1] = wp_xy[wp]
        veh_yaw[i + 1] = wp_yaw[wp]
        veh_wp[i + 1] = wp
        veh_alive[i + 1] = True
        veh_target[i + 1] = (NPC_TARGET_SPEED_KMH * rng.uniform(0.85, 1.15)) / 3.6

    # --- pedestrians: on sidewalks beside random waypoints ---
    ped_pos = np.zeros((num_pedestrians, 2), np.float32)
    ped_yaw = rng.uniform(-np.pi, np.pi, num_pedestrians).astype(np.float32)
    ped_speed = rng.uniform(1.0, 2.0, num_pedestrians).astype(np.float32)
    ped_alive = np.zeros((num_pedestrians,), bool)
    W = wp_xy.shape[0]
    side_off = LANE_WIDTH / 2 + LANE_WIDTH + SIDEWALK_WIDTH / 2
    for p in range(num_pedestrians):
        wp = int(rng.randint(W))
        yaw = wp_yaw[wp]
        right = np.array([np.sin(yaw), -np.cos(yaw)])
        ped_pos[p] = wp_xy[wp] + right * side_off
        ped_alive[p] = True

    world = dict(
        veh_pos=veh_pos, veh_yaw=veh_yaw, veh_speed=np.zeros(num_vehicles, np.float32),
        veh_alive=veh_alive, veh_control=np.zeros((num_vehicles, 3), np.float32),
        veh_reverse=np.zeros(num_vehicles, bool), veh_wp=veh_wp, veh_target_speed=veh_target,
        ped_pos=ped_pos, ped_yaw=ped_yaw, ped_speed=ped_speed, ped_alive=ped_alive,
        time_s=np.float32(0.0), step=np.int32(0), weather_idx=np.int32(weather_idx),
    )
    if return_info:
        return world, {"ego_wp": ego_wp, "ego_spawn": ego_spawn % len(spawns)}
    return world
