"""Batched data collection on the card (port of ``cilrs_tpu/data/collect.py``).

A fleet of envs rolls out in collect mode (the autopilot teacher, NPC traffic,
rendering and command labeling), all on the device; frames and labels come
back to the host once a chunk of ticks.

Output format (the JAX package's, itself the reference's): a session directory
with
 - ``measurements.csv`` with the reference's 14-column schema: frame,
   image_filename, steer, throttle, brake, speed_kmh, speed_normalized,
   high_level_command, command_name, position_x/y/z, yaw, timestamp;
 - ``aux.csv``: frame, obstacle_dist, tl_state (the teacher's gating inputs);
 - frames as ``frames_XXXX.npz`` shards (uint8 [N, 88, 200, 3]) by default, or
   individual JPEGs with ``image_format="jpeg"``;
 - ``summary.txt`` with the command distribution.
Stationary frames and recovery/teleport frames are skipped at the indexing
level. ``data.dataset.load_sessions`` (and so ``cli.train`` / ``cli.report``)
reads the session.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import signal
import time

import numpy as np
import torch

from cilrs_tpu_torch.agent.controller import ST_OK
from cilrs_tpu_torch.agent.driver import DT, DriverState, fleet_rollout, make_driver_state
from cilrs_tpu_torch.agent.npc import draw_pedestrians
from cilrs_tpu_torch.agent.scenario import spawn_world
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import (COMMAND_NAMES, SPEED_NORM_FACTOR, WEATHER_NAMES,
                                    WeatherTable, load_weather_table)
from cilrs_tpu_torch.core.convert import pool_from_arrays, world_from_arrays
from cilrs_tpu_torch.core.state import VehicleParams, default_vehicle_params
from cilrs_tpu_torch.data.dataset import CSV_HEADER
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.maps.routing import RoutePool, chained_route_pool
from cilrs_tpu_torch.render.camera import CameraSpec
from cilrs_tpu_torch.render.raster import CAMERA

MIN_SPEED_KMH = 0.5  # stationary-frame skip threshold
ROUTES_PER_ENV = 4
# Outputs a chunk copies to the host (the rest stay on the device).
HOST_KEYS = ("frame", "control", "speed_kmh", "command", "pos", "yaw", "status",
             "obstacle_dist", "tl_state")


@dataclasses.dataclass
class CollectFleet:
    """A fleet in collect mode on one device and the chunk that advances it."""

    net: RoadNetwork
    pool: RoutePool  # [E, K, R, ...]
    wt: WeatherTable
    params: VehicleParams
    cam: CameraSpec
    chunk_steps: int
    generator: torch.Generator
    state: DriverState
    # A rank's block of a sharded fleet (``parallel.fleet.shard_collect_fleet``):
    # the draws are the whole fleet's [T, draw_envs, P], of which the rank
    # keeps its envs, so an env's draws do not depend on the world size.
    draw_envs: int | None = None
    env_block: slice = slice(None)

    def chunk(self) -> dict:
        """``chunk_steps`` ticks; returns the outputs [E, T, ...] on the device."""
        w = self.state.world
        draws = draw_pedestrians(self.generator, self.chunk_steps, self.draw_envs or w.num_envs,
                                 w.num_pedestrians, w.veh_pos.device)[:, self.env_block]
        self.state, outs = fleet_rollout(
            self.state, self.chunk_steps, self.net, self.pool, self.wt, self.params, draws,
            mode="collect", cam=self.cam)
        return outs


def make_collect_fleet(
    net: RoadNetwork,
    num_envs: int = 16,
    num_vehicles: int = 12,
    num_pedestrians: int = 6,
    weather_idx: int | None = 0,
    seed: int = 0,
    chunk_steps: int = 100,
    cam: CameraSpec = CAMERA,
    device="cuda",
) -> CollectFleet:
    """Per-env chained route pools and spawns (host numpy, from one
    ``RandomState(seed)`` consumed as the JAX package consumes it), moved to
    the device as one batched fleet. ``weather_idx=None`` mixes the weathers,
    env e in weather e % 5 (the JAX package's ``data/resident.py:make_fleet``,
    which sets the fleet up as ``collect_session`` does but for the per-env
    PRNG keys the fleet's generator stands for here)."""
    dev = require_cuda(device)
    rng = np.random.RandomState(seed)
    h = net.host
    pools, worlds = [], []
    for e in range(num_envs):
        pool, meta = chained_route_pool(net, rng, num_routes=ROUTES_PER_ENV, min_dist=60.0,
                                        max_dist=280.0, with_meta=True)
        start_wp = meta["start_wps"][0]
        w_idx = e % len(WEATHER_NAMES) if weather_idx is None else weather_idx
        world = spawn_world(net, num_vehicles, num_pedestrians, rng, weather_idx=w_idx)
        world["veh_pos"][0] = h.wp_xy[start_wp]
        world["veh_yaw"][0] = h.wp_yaw[start_wp]
        pools.append(pool)
        worlds.append(world)
    return CollectFleet(
        net=net.to(dev), pool=pool_from_arrays(pools, dev), wt=load_weather_table(device=dev),
        params=default_vehicle_params(dev), cam=cam, chunk_steps=chunk_steps,
        generator=torch.Generator(device=dev).manual_seed(seed),
        state=make_driver_state(world_from_arrays(worlds, dev)))


def collect_session(
    net: RoadNetwork,
    output_dir: str,
    num_frames: int = 10_000,
    num_envs: int = 16,
    num_vehicles: int = 12,
    num_pedestrians: int = 6,
    weather_idx: int = 0,
    seed: int = 0,
    chunk_steps: int = 100,
    cam: CameraSpec = CAMERA,
    image_format: str = "npz",
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Collect ~num_frames labeled frames into ``output_dir``. Returns summary stats."""
    fleet = make_collect_fleet(net, num_envs, num_vehicles, num_pedestrians, weather_idx,
                               seed, chunk_steps, cam, device)
    os.makedirs(output_dir, exist_ok=True)

    # SIGINT-graceful stop: the first Ctrl-C finishes the current chunk,
    # writes the CSV tail + summary.txt and returns; a second one falls
    # through to the default handler.
    interrupted = {"flag": False}

    def _on_sigint(signum, frame_):
        interrupted["flag"] = True
        signal.signal(signal.SIGINT, prev_handler)
        print("\n  SIGINT: finishing current chunk, writing summary...", flush=True)

    try:
        prev_handler = signal.signal(signal.SIGINT, _on_sigint)
    except ValueError:  # non-main thread (tests): no handler, no graceful stop
        prev_handler = None

    total = 0
    shard_id = 0
    cmd_counts = np.zeros(4, np.int64)
    t0 = time.time()
    with open(os.path.join(output_dir, "measurements.csv"), "w", newline="") as csv_f, \
            open(os.path.join(output_dir, "aux.csv"), "w", newline="") as aux_f:
        writer = csv.writer(csv_f)
        writer.writerow(CSV_HEADER)
        # Sidecar with the teacher's gating inputs (obstacle distance,
        # traffic-light state), for label-noise analysis on observables.
        aux_writer = csv.writer(aux_f)
        aux_writer.writerow(["frame", "obstacle_dist", "tl_state"])
        while total < num_frames and not interrupted["flag"]:
            outs = {k: v.cpu().numpy() for k, v in fleet.chunk().items() if k in HOST_KEYS}
            frames = outs["frame"]  # [E, T, H, W, 3] uint8
            speeds = outs["speed_kmh"]  # [E, T]
            E, T = speeds.shape
            # Stationary-frame skip plus label hygiene: drop recovery/teleport
            # frames, whose controls come from the recovery machine, not the
            # teacher.
            keep = (speeds.reshape(-1) > MIN_SPEED_KMH) & (outs["status"].reshape(-1) == ST_OK)
            idx = np.nonzero(keep)[0]
            if idx.size == 0:
                continue
            fr = frames.reshape(E * T, *frames.shape[2:])[idx]
            ct = outs["control"].reshape(E * T, 3)[idx]
            sp = speeds.reshape(-1)[idx]
            cm = outs["command"].reshape(-1)[idx]
            po = outs["pos"].reshape(E * T, 2)[idx]
            yw = outs["yaw"].reshape(-1)[idx]
            od = outs["obstacle_dist"].reshape(-1)[idx]
            tl = outs["tl_state"].reshape(-1)[idx]

            shard_name = f"frames_{shard_id:04d}.npz"
            if image_format == "npz":
                np.savez_compressed(os.path.join(output_dir, shard_name), frames=fr)
                fnames = [f"{shard_name}#{k}" for k in range(len(idx))]
            else:
                from PIL import Image

                fnames = []
                for k in range(len(idx)):
                    fn = f"frame_{total + k:08d}.jpg"
                    Image.fromarray(fr[k]).save(os.path.join(output_dir, fn), quality=95)
                    fnames.append(fn)

            now = time.time()
            for k in range(len(idx)):
                cmd_i = int(cm[k])
                cmd_counts[cmd_i] += 1
                writer.writerow([
                    total + k, fnames[k],
                    f"{ct[k, 0]:.6f}", f"{ct[k, 1]:.6f}", f"{ct[k, 2]:.6f}",
                    f"{sp[k]:.3f}",
                    f"{min(sp[k] / SPEED_NORM_FACTOR, 1.0):.6f}",
                    cmd_i, COMMAND_NAMES[cmd_i],
                    f"{po[k, 0]:.3f}", f"{po[k, 1]:.3f}", "0.000",
                    f"{np.degrees(yw[k]):.3f}", f"{now:.3f}",
                ])
                aux_writer.writerow([total + k, f"{od[k]:.3f}", int(tl[k])])
            total += len(idx)
            shard_id += 1
            if verbose:
                fps = total / max(time.time() - t0, 1e-9)
                print(f"  collected {total}/{num_frames} frames ({fps:.0f} frames/s)")

    if prev_handler is not None and not interrupted["flag"]:
        signal.signal(signal.SIGINT, prev_handler)
    stats = {
        "interrupted": interrupted["flag"],
        "frames": total,
        "command_distribution": {COMMAND_NAMES[i]: int(cmd_counts[i]) for i in range(4)},
        "wall_time_s": time.time() - t0,
        "frames_per_sec": total / max(time.time() - t0, 1e-9),
        "sim_hz": total / max(DT * chunk_steps * shard_id, 1e-9),
    }
    _save_summary(output_dir, stats, num_envs, weather_idx)
    return stats


def _save_summary(output_dir: str, stats: dict, num_envs: int, weather_idx: int):
    """summary.txt (reference collect_data.py:774-818)."""
    lines = [
        "=" * 50,
        "DATA COLLECTION SUMMARY",
        "=" * 50,
        f"Total frames:   {stats['frames']}",
        f"Weather:        {WEATHER_NAMES[weather_idx]}",
        f"Parallel envs:  {num_envs}",
        f"Wall time:      {stats['wall_time_s']:.1f} s",
        f"Throughput:     {stats['frames_per_sec']:.0f} frames/s",
        "",
        "Command distribution:",
    ]
    total = max(stats["frames"], 1)
    for name, count in stats["command_distribution"].items():
        lines.append(f"  {name:12s} {count:8d}  ({100.0 * count / total:.1f}%)")
    with open(os.path.join(output_dir, "summary.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
