"""Scenes for the render kernels' tests (no JAX: the card's tests import
this too): worlds as ``render/raster.py:render_frame`` takes them."""

import numpy as np
import torch

from cilrs_tpu_torch.agent.scenario import spawn_world
from cilrs_tpu_torch.bench.env_steps import NUM_PEDESTRIANS, NUM_VEHICLES, TOWN_BLOCKS
from cilrs_tpu_torch.core.convert import world_from_arrays
from cilrs_tpu_torch.maps import town

NUM_WEATHERS = 5


def staged_world(net, num_envs: int = 5, seed: int = 0, brake: float = 0.0, device="cpu"):
    """Envs in turn on a spawn point and 15 m before a traffic light, weather
    e % 5: an NPC 18 m ahead (braking with ``brake``), one oncoming in the
    next lane, one behind, two walkers, and lights in view (the scene of
    tests/test_torch_render.py, without JAX)."""
    h = net.host
    r = np.random.RandomState(seed)
    worlds = []
    for e in range(num_envs):
        if e % 2 == 0:
            wp = int(h.spawn_wp[r.randint(len(h.spawn_wp))])
            xy, yaw = h.wp_xy[wp], float(h.wp_yaw[wp])
        else:
            li = r.randint(len(h.light_xy))
            yaw = float(h.light_yaw[li])
            xy = h.light_xy[li] - 15.0 * np.array([np.cos(yaw), np.sin(yaw)])
        fwd = np.array([np.cos(yaw), np.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        control = np.zeros((4, 3), np.float32)
        control[1, 2] = brake
        worlds.append(dict(
            veh_pos=np.stack([xy, xy + fwd * 18, xy + fwd * 40 + left * 3.5,
                              xy - fwd * 15]).astype(np.float32),
            veh_yaw=np.array([yaw, yaw + 0.3, yaw + 3.14, yaw], np.float32),
            veh_speed=np.array([6.0 + e, 3, 0, 0], np.float32), veh_alive=np.ones(4, bool),
            veh_control=control, veh_reverse=np.zeros(4, bool), veh_wp=np.zeros(4, np.int64),
            veh_target_speed=np.zeros(4, np.float32),
            ped_pos=np.stack([xy + fwd * 10 + left * 4,
                              xy + fwd * 25 - left * 5]).astype(np.float32),
            ped_yaw=np.zeros(2, np.float32), ped_speed=np.zeros(2, np.float32),
            ped_alive=np.ones(2, bool), time_s=np.float32(3.7 + 11 * e), step=np.int64(0),
            weather_idx=np.int64(e % NUM_WEATHERS)))
    return world_from_arrays(worlds, device)


def fleet_world(net, num_envs: int, seed: int = 0, device="cpu"):
    """``num_envs`` envs spawned as bench.py spawns one (12 vehicles, 5
    walkers), each from its own draw, in weather e % 5, with drawn speeds
    (some reversing), brakes, dead NPCs and walkers, and times."""
    r = np.random.RandomState(seed)
    worlds = []
    for e in range(num_envs):
        w = spawn_world(net, NUM_VEHICLES, NUM_PEDESTRIANS, np.random.RandomState(seed * 7919 + e))
        V, P = len(w["veh_yaw"]), len(w["ped_pos"])
        w["veh_speed"] = r.uniform(-2.0, 14.0, V).astype(np.float32)
        w["veh_control"] = r.uniform(0.0, 1.0, (V, 3)).astype(np.float32)
        w["veh_reverse"] = w["veh_speed"] < 0
        w["veh_alive"] = w["veh_alive"] & (r.uniform(size=V) > 0.1)
        w["veh_alive"][0] = True
        w["ped_alive"] = r.uniform(size=P) > 0.2
        w["time_s"] = np.float32(r.uniform(0.0, 300.0))
        w["weather_idx"] = np.int64(e % NUM_WEATHERS)
        worlds.append(w)
    return world_from_arrays(worlds, device)


def bench_town():
    """bench.py's town (``bench/env_steps.py:make_bench_fleet``)."""
    return town.make_town01(blocks_x=TOWN_BLOCKS, blocks_y=TOWN_BLOCKS)


def frame_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How two frames differ: values unequal, beyond 1e-5 and beyond 0.05
    (shares), the mean and the largest difference."""
    d = (got.float() - want.float()).abs()
    share = lambda x: float((d > x).float().mean())  # noqa: E731
    return {"unequal": share(0.0), "beyond_1e5": share(1e-5), "beyond_005": share(0.05),
            "mean": float(d.mean()), "max": float(d.max())}
