"""The closed-loop driving step and the fleet rollout (port of
``cilrs_tpu/agent/driver.py``).

One tick of every env at once: route context, perception and the camera
(``env_observe``), then the policy (drive mode), the safety cascade or the
autopilot teacher, the recovery and stuck machines, NPC traffic, physics,
collisions, teleports, route switching and metrics (``env_act``). The JAX
package ``vmap``s one env's step and
``lax.scan``s it; here every tensor carries the env dimension E and
``fleet_rollout`` is a Python loop over ticks whose outputs stay on the device,
stacked [E, T, ...], until the caller copies them out once a chunk; JAX's
one-env ``env_step`` and its ``lax.scan``, ``rollout``, are ``fleet_rollout``.
No step of a tick reads the device from the host, so the host only issues
work.

Recovery semantics preserved from the reference:
 - collision recovery: brake 6 ticks -> reverse 40 ticks -> brake 6 ticks;
   >= 5 consecutive recoveries escalate to teleport;
 - stuck detection: < 3 m progress in 15 s, or > 25 s waiting for traffic,
   or 75 s without movement -> teleport;
 - off-road streak > 10 frames -> teleport;
 - teleport lands on the route ahead and resets controller/machine state;
   route completion switches to the next pre-traced route of the env's pool.

Two modes. ``collect``: the autopilot teacher drives and the rollout records
frames and labels. ``drive``: a policy (the CILRS network) reads each env's
normalized frame, speed and command, and its controls go through
``agent/controller.py:safety_controller``, the departure hold and the off-road
assist. Either mode runs the pinned-destination protocol with
``loop_routes=False``: one attempt, and once the destination is reached the
car parks and the metrics freeze. The JAX package's A/B switches
``CILRS_TPU_NO_REDHOLD=1`` and ``CILRS_TPU_NO_OFFROAD_ASSIST=1`` turn the red
hold and the off-road assist of drive mode off; they are read at every tick,
as the JAX package reads them when it traces the tick.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from cilrs_tpu_torch.agent import perception
from cilrs_tpu_torch.agent.autopilot import autopilot_controls
from cilrs_tpu_torch.agent.controller import (CtrlState, ST_OK, ST_RECOVERY, init_ctrl_state,
                                              reset_ctrl_state, safety_controller)
from cilrs_tpu_torch.agent.npc import npc_controller, pedestrian_step_targets
from cilrs_tpu_torch.config import SPEED_NORM_FACTOR, WeatherTable
from cilrs_tpu_torch.core.dynamics import detect_ego_collisions, world_physics_step
from cilrs_tpu_torch.core.geometry import const, norm, take
from cilrs_tpu_torch.core.state import TensorTree, VehicleParams, WorldState, tree_where
from cilrs_tpu_torch.evaluation.metrics import Metrics, init_metrics, update_metrics
from cilrs_tpu_torch.maps.network import LIGHT_RED, RoadNetwork, light_state_ages, light_states
from cilrs_tpu_torch.maps.routing import RoutePool, get_command, is_complete, localize, steer_hint
from cilrs_tpu_torch.models.policy_graph import ModelPolicy
from cilrs_tpu_torch.ops.image import normalize
from cilrs_tpu_torch.ops.sinf import reverse_steer
from cilrs_tpu_torch.render.camera import CameraSpec
from cilrs_tpu_torch.render.raster import CAMERA, render_frame
from cilrs_tpu_torch.utils.profiling import span

DT = 0.05  # 20 Hz, reference synchronous mode fixed_delta

REC_NONE, REC_BRAKE, REC_REVERSE, REC_BRAKE2 = 0, 1, 2, 3
REC_BRAKE_S = 0.3  # 6 ticks
REC_REVERSE_S = 2.0  # 40 ticks
REC_TOTAL_S = REC_BRAKE_S + REC_REVERSE_S + REC_BRAKE_S
MAX_CONSECUTIVE_RECOVERIES = 5
STUCK_DIST_M = 3.0
STUCK_TIME_S = 15.0
TRAFFIC_WAIT_MAX_S = 25.0
HARD_STUCK_S = 75.0  # red-hold backstop: ~3 light cycles with no movement
OFF_ROAD_STREAK_MAX = 10
TELEPORT_AHEAD = (5, 10, 15, 20)  # route offsets of the teleport candidates

MODES = ("collect", "drive")

# A tick's spans (``utils/profiling.py``); the observation and the action
# carry theirs as decorators.
_TICK = span("tick")
_POLICY = span("policy")


@dataclasses.dataclass(frozen=True)
class DriverState(TensorTree):
    """The fleet's closed-loop state; every field [E, ...]."""

    world: WorldState
    ctrl: CtrlState
    metrics: Metrics
    route_id: torch.Tensor  # i64 into the env's RoutePool
    route_idx: torch.Tensor  # i64 position along the active route
    recovery_mode: torch.Tensor  # i64
    recovery_start: torch.Tensor  # f32
    consecutive_recoveries: torch.Tensor  # i64
    had_collision: torch.Tensor  # bool latch from last tick
    stuck_anchor_pos: torch.Tensor  # [E, 2]
    stuck_anchor_time: torch.Tensor  # f32
    move_anchor_pos: torch.Tensor  # [E, 2] — refreshes on movement ONLY
    move_anchor_time: torch.Tensor  # f32 — hard-stuck backstop clock
    off_road_streak: torch.Tensor  # i64
    violation_cd_until: torch.Tensor  # f32 — red-light violation debounce
    route_done: torch.Tensor  # bool — completion latch for non-looping runs


def make_driver_state(world: WorldState, route_id: int = 0) -> DriverState:
    E, dev = world.num_envs, world.veh_pos.device
    i64 = lambda v: torch.full((E,), v, dtype=torch.int64, device=dev)
    f32 = lambda v: torch.full((E,), v, dtype=torch.float32, device=dev)
    no = torch.zeros(E, dtype=torch.bool, device=dev)
    return DriverState(
        world=world,
        ctrl=init_ctrl_state(E, dev),
        metrics=init_metrics(E, dev),
        route_id=i64(route_id),
        route_idx=i64(0),
        recovery_mode=i64(REC_NONE),
        recovery_start=f32(-1e9),
        consecutive_recoveries=i64(0),
        had_collision=no,
        stuck_anchor_pos=world.veh_pos[:, 0].clone(),
        stuck_anchor_time=f32(0.0),
        move_anchor_pos=world.veh_pos[:, 0].clone(),
        move_anchor_time=f32(0.0),
        off_road_streak=i64(0),
        violation_cd_until=f32(-1.0),
        route_done=no,
    )


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")


@span("observe")
def env_observe(state: DriverState, net: RoadNetwork, pool: RoutePool,
                cam: CameraSpec = CAMERA, mode: str = "collect", want_frame: bool = True) -> dict:
    """Observation phase of every env: route context, perception, camera.
    pool is the fleet's [E, K, R, ...] route pools. ``want_frame=False``
    skips the render (the frame is None)."""
    _check_mode(mode)
    world = state.world
    route = pool.get(state.route_id)
    lights = light_states(net, world.time_s)
    ego_pos, ego_yaw = world.ego_pos, world.ego_yaw
    speed_kmh = world.ego_speed.abs() * 3.6

    route_idx = localize(route, state.route_idx, ego_pos)
    cmd = get_command(route, route_idx)
    hint = steer_hint(route, route_idx, ego_pos, ego_yaw)

    # Teacher labels use the instantaneous corridor only (observable from one
    # frame); the deploy-time safety layer keeps the predictive horizons. The
    # queue-aware red hold is drive-only: off in collect mode.
    drive = mode == "drive"
    obs_dist = perception.get_obstacle_distance(
        world, horizons=perception.PREDICT_HORIZONS if drive else (0.0,))
    tl_state, tl_idx = perception.check_traffic_light(net, lights, ego_pos, ego_yaw)
    if drive and os.environ.get("CILRS_TPU_NO_REDHOLD") != "1":
        red_ahead = perception.red_light_ahead(net, lights, ego_pos, ego_yaw)
    else:
        red_ahead = torch.zeros_like(tl_state, dtype=torch.bool)
    on_road = ~perception.ego_off_road(net, ego_pos)

    frame = render_frame(net, world, lights, cam) if want_frame else None

    return {
        "route": route, "lights": lights,
        "route_idx": route_idx, "cmd": cmd, "hint": hint,
        "obs_dist": obs_dist, "tl_state": tl_state, "tl_idx": tl_idx,
        "red_ahead": red_ahead,
        "on_road": on_road, "frame": frame, "speed_kmh": speed_kmh,
        "speed_norm": torch.clamp(speed_kmh / SPEED_NORM_FACTOR, 0.0, 1.0),
    }


def _set_ego(x: torch.Tensor, ego: torch.Tensor) -> torch.Tensor:
    """x [E, V, ...] with vehicle 0 replaced by ego [E, ...]."""
    return torch.cat([ego.unsqueeze(1).to(x.dtype), x[:, 1:]], dim=1)


@span("act")
def env_act(
    state: DriverState,
    obs: dict,
    ped_draws: torch.Tensor,  # [E, P] uniforms of the pedestrians' re-aim
    net: RoadNetwork,
    pool: RoutePool,
    wt: WeatherTable,
    params: VehicleParams,
    mode: str = "collect",
    nn_controls: torch.Tensor | None = None,
    loop_routes: bool = True,
    hold_until_s: float = 0.0,
):
    """Action phase of every env: the safety cascade on the policy's
    ``nn_controls`` [E, 3] (drive mode) or the autopilot teacher (collect
    mode), machines, physics, events, metrics. Consumes the observation dict
    of ``env_observe``; its frame, when not None, is output quantized to u8.

    hold_until_s > 0 parks the ego (brake 0.8) in drive mode until that sim
    time: the benchmark's departure-phase sweep (``cli.drive --depart-delay``).
    loop_routes=False is the pinned-destination protocol: one attempt, then
    the car parks a tick after arrival and the metrics freeze.
    """
    _check_mode(mode)
    world = state.world
    E, dev = world.num_envs, world.veh_pos.device
    now = world.time_s
    route = obs["route"]
    route_idx = obs["route_idx"]
    cmd, hint = obs["cmd"], obs["hint"]
    obs_dist, tl_state, tl_idx = obs["obs_dist"], obs["tl_state"], obs["tl_idx"]
    on_road, speed_kmh = obs["on_road"], obs["speed_kmh"]
    ego_pos, ego_yaw = world.ego_pos, world.ego_yaw
    no_event = torch.zeros(E, dtype=torch.bool, device=dev)

    if mode == "drive":
        control, reverse, status, ctrl2, events = safety_controller(
            net, world, state.ctrl, wt, nn_controls[:, 0], nn_controls[:, 1], nn_controls[:, 2],
            speed_kmh, cmd, hint, obs_dist, tl_state, obs["red_ahead"])
        if hold_until_s > 0.0:
            holding = now < hold_until_s
            control = torch.where(holding[:, None], const((0.0, 0.0, 0.8), torch.float32, dev),
                                  control)
            reverse = reverse & ~holding
        # Off-road recovery steer: while off the drivable surface, steer
        # hint-dominant back toward the route at reduced throttle instead of
        # riding the model's drift into the 10-frame streak teleport.
        if os.environ.get("CILRS_TPU_NO_OFFROAD_ASSIST") != "1":
            assist = torch.stack([torch.clamp(0.7 * hint + 0.3 * control[:, 0], -1.0, 1.0),
                                  torch.clamp(control[:, 1], max=0.4), control[:, 2]], dim=-1)
            control = torch.where(on_road[:, None], control, assist)
        ev_red_light_stop = events["red_light_stop"]
        ev_obstacle_brake = events["obstacle_brake"]
        ev_teleport_request = events["teleport_request"]
    else:
        a_steer, a_thr, a_brk = autopilot_controls(
            route, route_idx, ego_pos, ego_yaw, speed_kmh, obs_dist, tl_state)
        control = torch.stack([a_steer, a_thr, a_brk], dim=-1)  # [E, 3]
        reverse = no_event
        status = torch.full((E,), ST_OK, dtype=torch.int64, device=dev)
        red_now = tl_state == LIGHT_RED
        ctrl2 = state.ctrl.replace(waiting_for_red=red_now)
        ev_red_light_stop = red_now & ~state.ctrl.waiting_for_red
        ev_obstacle_brake = ev_teleport_request = no_event

    # --- collision recovery machine ---
    rec_mode, rec_start = state.recovery_mode, state.recovery_start
    consec = state.consecutive_recoveries
    idle = rec_mode == REC_NONE
    escalate = state.had_collision & idle & (consec >= MAX_CONSECUTIVE_RECOVERIES)
    start_rec = state.had_collision & idle & ~escalate
    rec_mode = torch.where(start_rec, REC_BRAKE, rec_mode)
    rec_start = torch.where(start_rec, now, rec_start)
    consec = torch.where(start_rec, consec + 1, consec)
    rec_el = now - rec_start
    rec_mode = torch.where((rec_mode == REC_BRAKE) & (rec_el > REC_BRAKE_S), REC_REVERSE, rec_mode)
    rec_mode = torch.where((rec_mode == REC_REVERSE) & (rec_el > REC_BRAKE_S + REC_REVERSE_S),
                           REC_BRAKE2, rec_mode)
    rec_done = (rec_mode == REC_BRAKE2) & (rec_el > REC_TOTAL_S)
    rec_mode = torch.where(rec_done, REC_NONE, rec_mode)
    rec_active = rec_mode != REC_NONE
    rsteer = reverse_steer(rec_start)
    reversing = rec_mode == REC_REVERSE
    rec_control = torch.stack([torch.where(reversing, rsteer, 0.0),
                               torch.where(reversing, 0.5, 0.0),
                               torch.where(reversing, 0.0, 1.0)], dim=-1)
    control = torch.where(rec_active[:, None], rec_control, control)
    reverse = torch.where(rec_active, reversing, reverse)
    status = torch.where(rec_active, ST_RECOVERY, status)
    # Forget old recoveries once we've been clean for 20 s.
    consec = torch.where(~rec_active & (rec_el > 20.0), 0, consec)

    # --- stuck detection: waiting at a red light is NOT stuck ---
    at_red = (tl_state == LIGHT_RED) | obs["red_ahead"]
    moved = norm(ego_pos - state.stuck_anchor_pos)
    anchor_pos = torch.where((moved > STUCK_DIST_M)[:, None], ego_pos, state.stuck_anchor_pos)
    anchor_time = torch.where((moved > STUCK_DIST_M) | at_red, now, state.stuck_anchor_time)
    stuck_still = (now - anchor_time) > STUCK_TIME_S
    waiting_long = ctrl2.waiting_for_traffic & ((now - ctrl2.traffic_wait_start) > TRAFFIC_WAIT_MAX_S)
    # Backstop: an anchor that refreshes ONLY on movement bounds the red hold.
    moved2 = norm(ego_pos - state.move_anchor_pos)
    m_anchor_pos = torch.where((moved2 > STUCK_DIST_M)[:, None], ego_pos, state.move_anchor_pos)
    m_anchor_time = torch.where(moved2 > STUCK_DIST_M, now, state.move_anchor_time)
    hard_stuck = (now - m_anchor_time) > HARD_STUCK_S
    stuck = stuck_still | waiting_long | hard_stuck

    # --- NPC traffic + physics ---
    npc_ctl, veh_wp = npc_controller(net, world, obs["lights"])
    all_controls = _set_ego(npc_ctl, control)
    all_reverse = _set_ego(torch.zeros_like(world.veh_alive), reverse)
    friction = wt.friction[world.weather_idx]
    new_ped_yaw = pedestrian_step_targets(world, ped_draws)
    world2 = world_physics_step(world.replace(veh_wp=veh_wp, ped_yaw=new_ped_yaw),
                                all_controls, all_reverse, params, friction, DT)

    # --- post-physics events ---
    hit_v, hit_w = detect_ego_collisions(world2, params)
    had_collision = (hit_v | hit_w) & ~rec_active
    off_streak = torch.where(on_road, 0, state.off_road_streak + 1)
    off_far = off_streak > OFF_ROAD_STREAK_MAX

    # --- teleport (recovery escalation | stuck | off-road streak | reverse fallback) ---
    teleport = escalate | stuck | off_far | ev_teleport_request
    # Cause (0 none / 1 collision-escalate / 2 still / 3 wait / 4 hard-stuck /
    # 5 off-road / 6 reverse-fallback; first-true wins).
    causes = torch.stack([escalate, stuck_still, waiting_long, hard_stuck, off_far,
                          ev_teleport_request], dim=1)
    tp_cause = torch.where(teleport, torch.argmax(causes.to(torch.int32), dim=1) + 1, 0)
    # Candidate landing spots ahead on the route, first one clear of actors.
    ahead = const(TELEPORT_AHEAD, torch.int64, dev)
    cand_idx = torch.minimum(route_idx[:, None] + ahead, (route.length - 1)[:, None])  # [E, 4]
    cand_pos = take(route.xy, cand_idx)  # [E, 4, 2]
    d_veh = norm(cand_pos[:, :, None, :] - world2.veh_pos[:, None, 1:, :])  # [E, 4, V-1]
    clear = (d_veh > 6.0).all(dim=2) | ~world2.veh_alive[:, 1:].any(dim=1, keepdim=True)
    pick = torch.argmax(clear.to(torch.int32), dim=1)  # first clear candidate
    pick = torch.where(clear.any(dim=1), pick, len(TELEPORT_AHEAD) - 1)  # none clear: farthest
    tp_idx = torch.gather(cand_idx, 1, pick[:, None])[:, 0]
    tp_pos = take(route.xy, tp_idx)
    tp_yaw = take(route.yaw, tp_idx)
    world2 = world2.replace(
        veh_pos=_set_ego(world2.veh_pos, torch.where(teleport[:, None], tp_pos, world2.veh_pos[:, 0])),
        veh_yaw=_set_ego(world2.veh_yaw, torch.where(teleport, tp_yaw, world2.veh_yaw[:, 0])),
        veh_speed=_set_ego(world2.veh_speed, torch.where(teleport, 0.0, world2.veh_speed[:, 0])),
    )
    route_idx = torch.where(teleport, tp_idx, route_idx)
    ctrl2 = tree_where(teleport, reset_ctrl_state(ctrl2, now), ctrl2)
    rec_mode = torch.where(teleport, REC_NONE, rec_mode)
    consec = torch.where(teleport, 0, consec)
    anchor_pos = torch.where(teleport[:, None], tp_pos, anchor_pos)
    anchor_time = torch.where(teleport, now, anchor_time)
    m_anchor_pos = torch.where(teleport[:, None], tp_pos, m_anchor_pos)
    m_anchor_time = torch.where(teleport, now, m_anchor_time)
    off_streak = torch.where(teleport, 0, off_streak)
    had_collision = had_collision & ~teleport

    # --- route completion -> the next route of the env's pool; with
    # loop_routes=False (the pinned-destination protocol) one attempt, held ---
    at_dest = is_complete(route, world2.veh_pos[:, 0])
    completed = at_dest & ~state.route_done
    if loop_routes:
        route_id2 = torch.where(completed, (state.route_id + 1) % pool.num_routes, state.route_id)
        route_idx2 = torch.where(completed, 0, route_idx)
        route_done2 = no_event
        new_attempt = completed
    else:
        route_id2, route_idx2 = state.route_id, route_idx
        route_done2 = state.route_done | at_dest
        new_attempt = no_event

    # --- red-light violation: crossing the governing stop line at speed on a
    # red that has been red > 1.5 s (amber-dilemma grace). ---
    if net.num_lights > 0:
        li = torch.clamp(tl_idx, min=0)
        red_age = take(light_state_ages(net, now), li)
        lyaw = net.light_yaw[li]
        lfwd = torch.stack([torch.cos(lyaw), torch.sin(lyaw)], dim=-1)
        lon_to_line = torch.sum((world2.veh_pos[:, 0] - net.light_xy[li]) * lfwd, dim=-1)
        at_line = (lon_to_line > -2.0) & (tl_idx >= 0)
    else:
        red_age = torch.zeros(E, device=dev)
        at_line = no_event
    violation = (
        (tl_state == LIGHT_RED) & at_line & (speed_kmh > 15.0) & (red_age > 1.5)
        & (now > state.violation_cd_until)
    )
    violation_cd = torch.where(violation, now + 5.0, state.violation_cd_until)

    # In the pinned-destination protocol the run is over once the destination
    # is reached (the previous tick's latch): park the car, freeze the metrics.
    if not loop_routes:
        finished = state.route_done
        park = const((0.0, 0.0, 1.0), torch.float32, dev)
        world2 = world2.replace(
            veh_control=_set_ego(world2.veh_control,
                                 torch.where(finished[:, None], park, world2.veh_control[:, 0])),
            veh_speed=_set_ego(world2.veh_speed,
                               torch.where(finished, 0.0, world2.veh_speed[:, 0])))

    metrics = update_metrics(
        state.metrics, speed_kmh=speed_kmh, steer=control[:, 0], on_road=on_road, dt=DT,
        now=now, hit_vehicle=hit_v & ~rec_active, hit_walker=hit_w & ~rec_active,
        red_light_stop=ev_red_light_stop, red_light_violation=violation,
        obstacle_brake=ev_obstacle_brake, route_completed=completed,
        route_attempted=new_attempt,  # a new attempt starts when we loop onward
        teleported=teleport, recovered=start_rec,
    )
    if not loop_routes:
        metrics = tree_where(finished, state.metrics, metrics)

    new_state = DriverState(
        world=world2,
        ctrl=ctrl2,
        metrics=metrics,
        route_id=route_id2,
        route_idx=route_idx2,
        recovery_mode=rec_mode,
        recovery_start=rec_start,
        consecutive_recoveries=consec,
        had_collision=had_collision,
        stuck_anchor_pos=anchor_pos,
        stuck_anchor_time=anchor_time,
        move_anchor_pos=m_anchor_pos,
        move_anchor_time=m_anchor_time,
        off_road_streak=off_streak,
        violation_cd_until=violation_cd,
        route_done=route_done2,
    )
    outputs = {
        "control": control,
        "status": status,
        "command": cmd,
        "speed_kmh": speed_kmh,
        "steer_hint": hint,
        "obstacle_dist": obs_dist,
        "tl_state": tl_state,
        "pos": world2.veh_pos[:, 0],
        "yaw": world2.veh_yaw[:, 0],
        "route_idx": route_idx2,
        "completed": completed,
        # Teleport cause telemetry: rescues are invisible to the scoring.
        "tp_cause": tp_cause,
        "recovered": start_rec,
    }
    if obs["frame"] is not None:  # uint8 on the device: 4x less to copy out
        outputs["frame"] = (torch.clamp(obs["frame"], 0.0, 1.0) * 255.0).to(torch.uint8)
    return new_state, outputs


def fleet_rollout(
    fleet: DriverState,
    steps: int,
    net: RoadNetwork,
    pool: RoutePool,  # the fleet's pools, [E, K, R, ...]
    wt: WeatherTable,
    params: VehicleParams,
    ped_draws: torch.Tensor,  # [T, E, P] uniforms of the pedestrians' re-aim
    mode: str = "collect",
    cam: CameraSpec = CAMERA,
    policy=None,
    loop_routes: bool = True,
    hold_until_s: float = 0.0,
    want_frames: bool = True,
):
    """``steps`` ticks of the whole fleet. Returns (final state, outputs), the
    outputs stacked [E, T, ...] on the device, as ``jax.vmap(rollout)``
    stacks them. The pedestrians' draws come from
    ``agent.npc.draw_pedestrians`` (the tests pass the JAX package's).

    In drive mode ``policy(image [E, H, W, 3] normalized, speed_norm [E],
    cmd [E]) -> [E, 3]`` runs once a tick, batched over the fleet, under
    ``torch.inference_mode``, on the normalized float render (not the u8
    output). The JAX package's single-env ``rollout`` is this with E = 1.

    ``want_frames=False`` drops ``"frame"`` from the outputs and skips its u8
    quantize; in collect mode it skips the render too (drive mode renders
    for the policy). The default here is frames on, where the JAX
    function's is off.
    """
    _check_mode(mode)
    if mode == "drive" and policy is None:
        raise ValueError("drive mode needs a policy")
    world = fleet.world
    if ped_draws.shape != (steps, world.num_envs, world.num_pedestrians):
        raise ValueError(f"ped_draws {tuple(ped_draws.shape)}, expected "
                         f"{(steps, world.num_envs, world.num_pedestrians)}")
    ticks = []
    state = fleet
    for t in range(steps):
        with _TICK:
            obs = env_observe(state, net, pool, cam, mode=mode,
                              want_frame=want_frames or mode == "drive")
            nn = None
            if mode == "drive":
                with _POLICY, torch.inference_mode():
                    nn = policy(normalize(obs["frame"]), obs["speed_norm"], obs["cmd"])
                if not want_frames:
                    obs["frame"] = None
            state, outs = env_act(state, obs, ped_draws[t], net, pool, wt, params, mode=mode,
                                  nn_controls=nn, loop_routes=loop_routes,
                                  hold_until_s=hold_until_s)
            ticks.append(outs)
    return state, {k: torch.stack([o[k] for o in ticks], dim=1) for k in ticks[0]} if ticks else {}


def model_policy(model: torch.nn.Module) -> ModelPolicy:
    """A CILRS model as a fleet policy: its controls, without the speed head,
    a fresh tensor each call; on the card, in eval mode with grad off,
    replayed from a CUDA graph of the forward (``models/policy_graph.py``)."""
    return ModelPolicy(model)
