"""Per-phase cost of the closed-loop env step at bench shapes (port of
``tools/profile_step.py``).

    python -m cilrs_tpu_torch.tools.profile_step [E] [--device cpu]

Times each phase of the drive tick on ``bench.env_steps``'s fleet of E envs
(default 128), each phase called alone on the fleet's state: the full render,
the ground masks, the vehicle boxes, the building boxes, the motion blur,
perception with its 3 horizons, the batched policy forward, NPC + physics;
then the full chunk (20 ticks) for the headline number. Each phase: one
warm-up call, then 10 calls (the chunk: 5) timed with the host's clock to a
synchronize (wall ms a call). The port's phases are eager and paced by the
host where the card's work is shorter than their issue, so on the card each
line also gives the device ms of one more call (torch.profiler: the
kernels' and copies' time, summed) and its device activities, profiled
after every wall time is taken; on the CPU they are not measured.
"""

from __future__ import annotations

import argparse
import time

import torch

from cilrs_tpu_torch.agent import perception
from cilrs_tpu_torch.agent.npc import npc_controller
from cilrs_tpu_torch.bench.env_steps import device_fields, make_bench_fleet, synchronize
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.core.dynamics import world_physics_step
from cilrs_tpu_torch.maps.network import light_states
from cilrs_tpu_torch.render import raster
from cilrs_tpu_torch.render.camera import camera_position, ray_directions

# Timed calls a phase, and the chunk's ticks and timed calls (the JAX
# tool's); read at each call.
REPS = 10
CHUNK_TICKS, CHUNK_REPS = 20, 5


def timeit(fn, dev: torch.device, reps: int) -> float:
    """Wall ms a call of fn: one warm-up call, then ``reps`` calls timed with
    the host's clock to a synchronize."""
    fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def phases(fleet) -> dict:
    """The phases of a tick, each a function of no arguments on the fleet's
    state, as the JAX tool cuts them."""
    net, w, spec = fleet.net, fleet.state.world, raster.CAMERA
    E, dev = w.num_envs, w.veh_pos.device
    oz = torch.tensor(spec.offset_up, dtype=torch.float32).item()  # render_frame's camera height

    def rays_from_camera():
        o = camera_position(spec, w.ego_pos, w.ego_yaw)
        return o, ray_directions(spec, w.ego_yaw).reshape(E, -1, 3)

    def ground_only():
        o, rays = rays_from_camera()
        dz = rays[..., 2]
        t_ground = torch.where(dz < -1e-4, o[:, 2:3] / torch.clamp(-dz, min=1e-6), raster.INF)
        gxy = o[:, None, :2] + rays[..., :2] * t_ground[..., None]
        return raster._ground_masks(net, w.ego_pos, gxy)

    def veh_only():
        o, rays = rays_from_camera()
        full = lambda v: torch.full((E, w.num_vehicles - 1), v, device=dev)
        t, _ = raster._ray_obb(oz, rays, w.veh_pos[:, 1:] - o[:, None, :2], w.veh_yaw[:, 1:],
                               full(4.7 / 2), full(1.0), full(raster.VEH_HEIGHT))
        return t.amin(dim=-1)

    def bldg_only():
        o, rays = rays_from_camera()
        kb = min(raster.NUM_NEAR_BUILDINGS, net.bldg_xy.shape[0])
        near = raster.nearest_k(torch.sum((net.bldg_xy - w.ego_pos[:, None]) ** 2, dim=-1), kb)
        t, _ = raster._ray_obb(oz, rays, net.bldg_xy[near] - o[:, None, :2], net.bldg_yaw[near],
                               net.bldg_half[near, 0], net.bldg_half[near, 1], net.bldg_h[near])
        return t.amin(dim=-1)

    img = torch.zeros((E, spec.height, spec.width, 3), device=dev)

    def perc():
        lights = light_states(net, w.time_s)
        return (perception.get_obstacle_distance(w),
                perception.check_traffic_light(net, lights, w.ego_pos, w.ego_yaw),
                perception.ego_off_road(net, w.ego_pos))

    x = torch.zeros((E, spec.height, spec.width, 3), device=dev)
    sp, cmd = torch.zeros(E, device=dev), torch.zeros(E, dtype=torch.int64, device=dev)

    def pol():
        with torch.inference_mode():
            return fleet.policy(x, sp, cmd)

    def phys():
        ctl, wp = npc_controller(net, w, light_states(net, w.time_s))
        return world_physics_step(w.replace(veh_wp=wp), ctl, torch.zeros_like(w.veh_alive),
                                  fleet.params, fleet.wt.friction[w.weather_idx], 0.05)

    return {
        "render_frame (full)": lambda: raster.render_frame(net, w, light_states(net, w.time_s)),
        "ground masks only": ground_only,
        "vehicle OBB only": veh_only,
        "buildings OBB only": bldg_only,
        "motion blur only": lambda: raster.motion_blur(img, w.veh_speed[:, 0].abs() * 3.6),
        "perception (3-horizon)": perc,
        "policy forward (batched)": pol,
        "npc + physics": phys,
    }


def profile(num_envs: int = 128, device="cuda") -> dict:
    """The nine timings on bench.py's fleet of ``num_envs`` envs: {phase:
    {wall_ms, device_ms, device_activities}}, the full chunk's with its
    env-steps/s. Every wall time is taken before the profiler first runs."""
    dev = require_cuda(device)
    fleet = make_bench_fleet(num_envs, CHUNK_TICKS, dev)
    print(f"# E={num_envs} device={device_fields(dev)}", flush=True)
    fns = phases(fleet)
    chunk_name = f"fused chunk ({CHUNK_TICKS} ticks)"
    fns[chunk_name] = fleet.chunk
    out = {name: {"wall_ms": timeit(fn, dev, CHUNK_REPS if name == chunk_name else REPS),
                  "device_ms": None, "device_activities": None} for name, fn in fns.items()}
    for name, fn in fns.items():
        if dev.type == "cuda":  # one more call each, under the profiler
            from cilrs_tpu_torch.bench.timing import profiled_device_time

            out[name]["device_ms"], out[name]["device_activities"] = profiled_device_time(fn)
        r = out[name]
        device = ("not measured" if r["device_ms"] is None
                  else f"{r['device_ms']:9.3f} ms device, {r['device_activities']} activities")
        print(f"{name:34s} {r['wall_ms']:9.3f} ms wall  {device}", flush=True)
    chunk = out[chunk_name]
    chunk["env_steps_per_s"] = num_envs * CHUNK_TICKS / chunk["wall_ms"] * 1e3
    print(f"{'':34s} -> {chunk['env_steps_per_s']:,.0f} env-steps/s", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="per-phase cost of the env step at bench shapes "
                                            "(PyTorch/CUDA)")
    p.add_argument("envs", nargs="?", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return profile(args.envs, args.device)


if __name__ == "__main__":
    main()
