"""Closed-loop driving / evaluation CLI (port of ``cilrs_tpu/cli/drive.py``).

Flag parity with the JAX package's CLI (the reference's --checkpoint
--duration --spawn --destination --vehicles --pedestrians --no-hud --map,
plus --weather, --seed, --save-video, --report-json, --events-json,
--depart-delay, --autopilot, --view), and ``--device`` (default ``cuda``):

    python -m cilrs_tpu_torch.cli.drive --duration 120 --spawn 0 --destination 50 \\
        --vehicles 40 --pedestrians 5 --weather clear --no-hud [--device cpu]

The env steps on the device in chunks of 40 ticks (2 s of sim); the host reads
the scores, the status line, the events and the arrival latch only at chunk
boundaries. The pedestrians' re-aim draws come from a ``torch.Generator``
seeded by ``--seed`` (as ``data/collect.py:CollectFleet`` draws them), where
the JAX package splits a PRNG key: a drive run therefore matches the JAX one
everywhere except the walkers' paths.

``--depart-delay`` keeps two faults of the JAX CLI on purpose (ROADMAP Queue 3):
the run is extended by the delay even with ``--autopilot``, which never holds,
and the delay is not checked against the 15 s stuck-still window.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from cilrs_tpu_torch.agent.driver import (DT, DriverState, fleet_rollout, make_driver_state,
                                          model_policy)
from cilrs_tpu_torch.agent.npc import draw_pedestrians
from cilrs_tpu_torch.agent.scenario import spawn_world
from cilrs_tpu_torch.cli.common import build_map, load_policy, require_cuda
from cilrs_tpu_torch.config import (WEATHER_NAMES, WeatherTable, load_scoring_config,
                                    load_weather_table, weather_index)
from cilrs_tpu_torch.core.convert import pool_from_arrays, world_from_arrays
from cilrs_tpu_torch.core.state import VehicleParams, default_vehicle_params
from cilrs_tpu_torch.evaluation.hud import HAS_CV2, STATUS_NAMES, DashboardHUD
from cilrs_tpu_torch.evaluation.scoring import compute_scores, format_report
from cilrs_tpu_torch.maps.network import RoadNetwork, light_states
from cilrs_tpu_torch.maps.routing import RoutePool, chained_route_pool, trace_route

CHUNK_TICKS = 40  # 2 s of sim per host round trip
TP_CAUSES = {1: "collision-escalate", 2: "stuck-still", 3: "traffic-wait",
             4: "hard-stuck", 5: "off-road", 6: "reverse-fallback"}
# Outputs a chunk copies to the host (the frames only for the HUD or video).
HOST_KEYS = ("tp_cause", "recovered", "pos", "speed_kmh", "obstacle_dist", "tl_state",
             "command", "status", "control")


@dataclasses.dataclass
class DriveRun:
    """One env in closed loop on one device, and the chunk that advances it."""

    net: RoadNetwork
    pool: RoutePool  # [1, K, R, ...]
    wt: WeatherTable
    params: VehicleParams
    policy: object  # fleet_rollout's policy, None with the autopilot
    generator: torch.Generator
    state: DriverState
    loop_routes: bool
    hold_until_s: float

    @property
    def mode(self) -> str:
        return "collect" if self.policy is None else "drive"

    def chunk(self, ticks: int = CHUNK_TICKS) -> dict:
        """``ticks`` ticks; returns the outputs [1, T, ...] on the device."""
        w = self.state.world
        draws = draw_pedestrians(self.generator, ticks, 1, w.num_pedestrians, w.veh_pos.device)
        self.state, outs = fleet_rollout(
            self.state, ticks, self.net, self.pool, self.wt, self.params, draws, mode=self.mode,
            policy=self.policy, loop_routes=self.loop_routes, hold_until_s=self.hold_until_s)
        return outs


def make_drive_run(net: RoadNetwork, spawn: int | None = None, destination: int | None = None,
                   vehicles: int = 20, pedestrians: int = 5, weather: str = "clear",
                   seed: int = 0, checkpoint: str | None = None, autopilot: bool = False,
                   depart_delay: float = 0.0, device="cuda"):
    """The spawned world, its routes and the policy on ``device``, as the JAX
    CLI sets them up from one ``RandomState(seed)``: a one-route pool to
    ``destination`` (the pinned-destination protocol, no looping), else six
    chained routes. Returns (run, route length in m or None)."""
    dev = require_cuda(device)
    rng = np.random.RandomState(seed)
    world, info = spawn_world(net, vehicles + 1, pedestrians, rng, ego_spawn=spawn,
                              weather_idx=weather_index(weather), return_info=True)
    route_len_m = None
    if destination is not None:
        spawns = net.host.spawn_wp
        route = trace_route(net, info["ego_wp"], int(spawns[destination % len(spawns)]))
        if route is None:
            raise SystemExit("destination unreachable from spawn")
        pool = {k: v[None] for k, v in route.items()}
        rxy = route["xy"][: int(route["length"])]
        route_len_m = float(np.sum(np.hypot(*(rxy[1:] - rxy[:-1]).T)))
        print(f"  route: {int(route['length'])} waypoints, {route_len_m:.0f} m "
              f"to spawn point {destination}")
    else:
        pool = chained_route_pool(net, rng, num_routes=6, start_wp=info["ego_wp"])
    policy = None if autopilot else model_policy(load_policy(checkpoint, dev))
    run = DriveRun(net=net.to(dev), pool=pool_from_arrays([pool], dev),
                   wt=load_weather_table(device=dev), params=default_vehicle_params(dev),
                   policy=policy, generator=torch.Generator(device=dev).manual_seed(seed),
                   state=make_driver_state(world_from_arrays([world], dev)),
                   loop_routes=destination is None, hold_until_s=float(depart_delay))
    return run, route_len_m


def _events(outs: dict, base_t: float, scores: dict, prev_collisions: float) -> list:
    """A chunk's rescue and collision events, tick-accurate (host arrays [T])."""
    pos = outs["pos"]

    def ctx(k):
        return {
            "t_s": round(base_t + float(k) * DT, 2),
            "pos_before": [round(float(pos[max(k - 1, 0), 0]), 1),
                           round(float(pos[max(k - 1, 0), 1]), 1)],
            "pos_after": [round(float(pos[k, 0]), 1), round(float(pos[k, 1]), 1)],
            "speed_kmh": round(float(outs["speed_kmh"][k]), 1),
            "obstacle_dist": round(float(outs["obstacle_dist"][k]), 1),
            "tl_state": int(outs["tl_state"][k]),
            "command": int(outs["command"][k]),
            "status": STATUS_NAMES.get(int(outs["status"][k]), "?"),
        }

    tpc = outs["tp_cause"]
    events = [{"type": "teleport", "cause": TP_CAUSES.get(int(tpc[k]), "?"), **ctx(int(k))}
              for k in np.nonzero(tpc)[0]]
    events += [{"type": "recovery", **ctx(int(k))} for k in np.nonzero(outs["recovered"])[0]]
    if scores["collisions"] > prev_collisions:
        events.append({"type": "collision", "count": scores["collisions"],
                       **ctx(len(pos) - 1)})
    return events


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS closed-loop driving (PyTorch/CUDA)")
    p.add_argument("--checkpoint", default=None,
                   help="a .pth policy or a checkpoint directory (its best slot)")
    p.add_argument("--duration", type=float, default=120.0, help="seconds of sim time")
    p.add_argument("--spawn", type=int, default=None)
    p.add_argument("--destination", type=int, default=None)
    p.add_argument("--vehicles", type=int, default=20)
    p.add_argument("--pedestrians", type=int, default=5)
    p.add_argument("--weather", default="clear", choices=list(WEATHER_NAMES))
    p.add_argument("--no-hud", action="store_true")
    p.add_argument("--map", default="town01")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-video", default=None, help="write HUD frames to mp4")
    p.add_argument("--report-json", default=None)
    p.add_argument("--events-json", default=None,
                   help="write tick-accurate rescue/collision events "
                        "(teleport cause, position, context) for diagnosis")
    p.add_argument("--depart-delay", type=float, default=0.0,
                   help="park the ego (full brake) for this many sim seconds "
                        "before departing (keep < 15 s; the cap is extended by "
                        "the delay so moving time is unchanged)")
    p.add_argument("--autopilot", action="store_true",
                   help="drive with the rule-based teacher instead of the model")
    p.add_argument("--view", default="front", choices=["front", "chase"],
                   help="HUD/video viewpoint (chase = spectator cam)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    t_setup = time.time()
    print(f"Map: {args.map}")
    net = build_map(args.map)
    print(f"  {net.num_waypoints} waypoints, {net.num_lights} lights "
          f"({time.time() - t_setup:.1f}s)", flush=True)
    run, route_len_m = make_drive_run(
        net, args.spawn, args.destination, args.vehicles, args.pedestrians, args.weather,
        args.seed, args.checkpoint, args.autopilot, args.depart_delay, dev)
    print(f"  routes ready ({time.time() - t_setup:.1f}s)", flush=True)
    scoring = load_scoring_config()
    pool_end_xy = run.pool.xy[0, torch.arange(run.pool.num_routes), run.pool.length[0] - 1] \
        .cpu().numpy()  # host copy for the HUD's distance

    chase_render = None
    if args.view == "chase":
        from cilrs_tpu_torch.render.camera import CHASE_CAMERA
        from cilrs_tpu_torch.render.raster import render_frame

        def chase_render(w):
            return render_frame(run.net, w, light_states(run.net, w.time_s), CHASE_CAMERA,
                                include_ego=True)[0]

    hud = DashboardHUD() if not args.no_hud and HAS_CV2 else None
    compose_hud = DashboardHUD()  # also used headless for --save-video frames
    video = None
    if args.save_video:
        import cv2

        video = cv2.VideoWriter(args.save_video, cv2.VideoWriter_fourcc(*"mp4v"),
                                int(1 / DT / CHUNK_TICKS * 10), (960, 540))

    print(f"Driving for {args.duration:.0f} s sim time, weather={args.weather} ...")
    if args.depart_delay > 0.0:
        print(f"  departure-phase hold: {args.depart_delay:.0f} s "
              f"(cap extended to {args.duration + args.depart_delay:.0f} s)")
    total_ticks = int((args.duration + args.depart_delay) / DT)
    done_ticks = 0
    t_wall = time.time()
    running = True
    events = [] if args.events_json else None
    prev_collisions = 0.0
    want_frames = hud is not None or video is not None
    while done_ticks < total_ticks and running:
        outs = run.chunk()
        done_ticks += CHUNK_TICKS
        keys = HOST_KEYS + (("frame",) if want_frames and chase_render is None else ())
        host = {k: outs[k][0].cpu().numpy() for k in keys}
        scores = compute_scores(run.state.metrics, scoring)
        if events is not None:
            events += _events(host, (done_ticks - CHUNK_TICKS) * DT, scores, prev_collisions)
            prev_collisions = scores["collisions"]
        # Pinned-destination protocol: arrival parks the car and freezes the
        # metrics (agent/driver.py), so further chunks are dead time.
        if not run.loop_routes and bool(run.state.route_done[0]):
            print("  destination reached")
            break

        if want_frames:
            frame = (chase_render(run.state.world).cpu().numpy() if chase_render is not None
                     else host["frame"][-1])
            canvas = (hud or compose_hud).compose(
                frame,
                speed_kmh=float(host["speed_kmh"][-1]), command=int(host["command"][-1]),
                steer=float(host["control"][-1, 0]), throttle=float(host["control"][-1, 1]),
                brake=float(host["control"][-1, 2]), tl_state=int(host["tl_state"][-1]),
                obstacle_dist=float(host["obstacle_dist"][-1]),
                dest_remaining_m=float(np.linalg.norm(
                    pool_end_xy[int(run.state.route_id[0])] - host["pos"][-1])),
                status=int(host["status"][-1]), safety_pct=scores["safety"],
                distance_m=scores["total_distance_m"], collisions=int(scores["collisions"]),
                weather=args.weather)
            if video is not None:
                video.write(canvas)
            if hud is not None:
                running = hud.show(canvas)

        st = STATUS_NAMES.get(int(host["status"][-1]), "?")
        sim_t = done_ticks * DT
        rtf = sim_t / max(time.time() - t_wall, 1e-9)
        print(f"  t={sim_t:6.1f}s  v={float(host['speed_kmh'][-1]):5.1f} km/h  "
              f"cmd={int(host['command'][-1])}  {st:10s}  "
              f"score={scores['overall']:5.1f}  ({rtf:4.1f}x realtime)")

    if video is not None:
        video.release()
    if hud is not None:
        hud.close()

    scores = compute_scores(run.state.metrics, scoring)
    if route_len_m is not None:
        scores["route_length_m"] = route_len_m
    wall = time.time() - t_wall
    print(f"\nAvg sim rate: {done_ticks / wall:.1f} ticks/s "
          f"({done_ticks * DT / wall:.1f}x realtime)")
    print(format_report(scores))
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump({"weather": args.weather, **scores}, f, indent=2)
        print(f"report written to {args.report_json}")
    if events is not None:
        with open(args.events_json, "w") as f:
            json.dump(events, f, indent=1)
        print(f"{len(events)} events -> {args.events_json}")
    return scores


if __name__ == "__main__":
    main()
