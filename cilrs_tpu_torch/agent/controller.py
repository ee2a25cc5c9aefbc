"""The rule-based safety/speed controller and its overtake/reverse state
machine (port of ``cilrs_tpu/agent/controller.py``), batched over the fleet.

Every branch of the reference's priority cascade is a predicated lane of dense
arithmetic selected with ``torch.where``, so one call serves every env with no
data-dependent control flow and no host read. Priorities (highest first):
  RED light stop (brake 0.8) -> YELLOW under 30 km/h (brake 0.5) ->
  overtake / reverse override -> hard-brake zone 8*max(1, v/15) m ->
  slow / caution zones 16 / 25 m -> intersection brake-suppression + hint blend
  -> anti-stall UNSTICK (0.7 -> 0.85 throttle after 3 s / 6 s) ->
  banded speed governor with curve awareness (hard cap target+10).
Targets, thresholds, brake forces, steer damping and traction control come from
each env's row of the ``WeatherTable``.

The collect mode carries ``CtrlState`` too (the teacher sets
``waiting_for_red``; a teleport resets it); the cascade drives the drive mode.

``safety_cascade`` is the cascade's body; ``safety_controller``, the entry
point, runs it eagerly or, on the card, replays a CUDA graph of it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cilrs_tpu_torch.config import WeatherTable
from cilrs_tpu_torch.core.geometry import heading_vec
from cilrs_tpu_torch.core.state import TensorTree, WorldState, tree_leaves, tree_unflatten
from cilrs_tpu_torch.maps.network import LIGHT_RED, LIGHT_YELLOW, RoadNetwork
from cilrs_tpu_torch.maps.queries import nearest_lane_waypoint
from cilrs_tpu_torch.ops.filters import SmoothingState, init_smoothing, smooth_controls
from cilrs_tpu_torch.utils.cuda_graph import Graph, capture, replay
from cilrs_tpu_torch.utils.profiling import profiler_running, span

# Status codes (HUD/report strings in evaluation.hud.STATUS_NAMES).
ST_OK, ST_RED, ST_YELLOW, ST_BRAKE, ST_OVERTAKE_L, ST_OVERTAKE_R, ST_REVERSE, \
    ST_UNSTICK, ST_RECOVERY, ST_TELEPORT = range(10)

# Overtake machine states.
OV_NONE, OV_LEFT, OV_RIGHT, OV_REVERSE = 0, 1, 2, 3

INTERSECTION_SPEED = 18.0
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


# ---------------------------------------------------------------------------
# Overtake support
# ---------------------------------------------------------------------------


def _lane_clear(world: WorldState, lane_pos: torch.Tensor, lane_yaw: torch.Tensor) -> torch.Tensor:
    """[E] True if no actor occupies lateral +/-2.5 m, longitudinal (-5, 30) m
    of each env's lane axis (lane_pos [E, 2], lane_yaw [E])."""
    fwd = heading_vec(lane_yaw)[:, None]  # [E, 1, 2]

    def occupied(pos: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        rel = pos - lane_pos[:, None]  # [E, A, 2]
        lon = rel[..., 0] * fwd[..., 0] + rel[..., 1] * fwd[..., 1]
        lat = rel[..., 1] * fwd[..., 0] - rel[..., 0] * fwd[..., 1]
        inside = (lon > -5.0) & (lon < 30.0) & (lat.abs() <= 2.5) & alive
        return inside.any(dim=1)

    occ_v = occupied(world.veh_pos[:, 1:], world.veh_alive[:, 1:])
    occ_p = occupied(world.ped_pos, world.ped_alive)
    return ~(occ_v | occ_p)


def can_overtake(net: RoadNetwork, world: WorldState):
    """(left_ok, right_ok) [E]: an adjacent same-direction driving lane exists
    and is clear. The road network holds same-direction lanes only in
    wp_left/wp_right, mirroring the reference's lane-id sign check."""
    wp, _ = nearest_lane_waypoint(net, world.ego_pos)

    def check(adj):
        idx = torch.clamp(adj, min=0)
        return (adj >= 0) & _lane_clear(world, net.wp_xy[idx], net.wp_yaw[idx])

    return check(net.wp_left[wp]), check(net.wp_right[wp])


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


def _select(conds, values, default):
    """``jnp.select``: the value of the first true condition, else default;
    a where chain built from the last condition to the first."""
    out = default
    for c, v in zip(reversed(conds), reversed(values)):
        out = torch.where(c, v, out)
    return out


def safety_cascade(
    net: RoadNetwork,
    world: WorldState,
    ctrl: CtrlState,
    wt: WeatherTable,
    nn_steer: torch.Tensor,  # [E] raw model outputs
    nn_gas: torch.Tensor,
    nn_brake: torch.Tensor,
    speed_kmh: torch.Tensor,
    cmd: torch.Tensor,  # [E] int high-level command
    hint: torch.Tensor,  # [E] steer hint from the route
    obs_dist: torch.Tensor,  # [E] m (999 = none)
    tl_state: torch.Tensor,  # [E] int traffic-light state
    red_ahead: torch.Tensor,  # [E] bool — queued behind a red
):
    """The cascade's body, always eager (``safety_controller`` is the entry
    point). Returns (control [E, 3] (steer, throttle, brake), reverse [E]
    bool, status [E] int64, new CtrlState, events dict of [E] bools).

    red_ahead (perception.red_light_ahead): the lane's next light within 40 m
    is red even outside the 15 m obey gate, so the queue ahead is light-bound.
    The overtake trigger, the traffic-wait clock and the unstick hold while
    it is true: a lawful wait is not escalated into overtake -> reverse ->
    teleport.
    """
    now = world.time_s
    wi = world.weather_idx
    w = WeatherTable(**{f.name: getattr(wt, f.name)[wi] for f in dataclasses.fields(wt)})

    at_intersection = (cmd >= 1) & (cmd <= 3)
    target_speed = w.max_speed_kmh
    max_speed = w.max_speed_kmh + 10.0
    steer_in = nn_steer / w.steer_damping

    # Curve detection (thresholds from the weather profile).
    steer_mag = steer_in.abs()
    hint_mag = hint.abs()
    in_curve = (steer_mag > w.curve_threshold) | (hint_mag > w.curve_threshold)
    curve_factor = torch.maximum(steer_mag, hint_mag)
    current_target = torch.where(
        in_curve,
        torch.maximum(w.sharp_curve_speed_kmh, w.curve_speed_kmh - curve_factor * 15.0),
        torch.where(at_intersection, INTERSECTION_SPEED, target_speed),
    )

    # Braking zones scale with speed only; the weather's brake_factor scales
    # brake forces, never the zone geometry.
    speed_factor = torch.clamp(speed_kmh / 15.0, min=1.0)
    hard_dist = 8.0 * speed_factor
    slow_dist = 16.0 * speed_factor
    caution_dist = 25.0 * speed_factor

    red = tl_state == LIGHT_RED
    yellow_stop = (tl_state == LIGHT_YELLOW) & (speed_kmh < 30.0)
    light_gate = red | yellow_stop

    # --- overtake / reverse state machine ---
    left_ok, right_ok = can_overtake(net, world)
    either_ok = left_ok | right_ok
    waited = torch.where(ctrl.obstacle_wait_start > T_NONE / 2, now - ctrl.obstacle_wait_start, 0.0)
    red_grace = (now - ctrl.red_clear_time) > 10.0
    trigger = ((ctrl.ov_state == OV_NONE) & (obs_dist < 10.0) & (speed_kmh < 3.0) & (waited > 4.0)
               & red_grace & ~light_gate & ~red_ahead)
    start_lane = trigger & either_ok
    start_rev = trigger & ~either_ok & (waited > 8.0)
    side = torch.where(left_ok, OV_LEFT, OV_RIGHT)
    ov_state = torch.where(start_lane, side, ctrl.ov_state)
    ov_state = torch.where(start_rev, OV_REVERSE, ov_state)
    ov_start = torch.where(start_lane | start_rev, now, ctrl.ov_start)

    el = now - ov_start  # phase time
    lane_active = (ov_state == OV_LEFT) | (ov_state == OV_RIGHT)
    dir_sign = torch.where(ov_state == OV_LEFT, 1.0, -1.0)  # +steer = left
    # Timed phases: 0-2 s change, 2-5 s pass, 5-7 s return.
    ov_steer = torch.where(
        el < 2.0, dir_sign * 0.25 * (1.0 - el / 2.0),
        torch.where(el < 5.0, hint * 0.3,
                    -dir_sign * 0.2 * torch.clamp(1.0 - (el - 5.0) / 2.0, 0.0, 1.0)))
    ov_throttle = torch.where(el < 2.0, 0.5, torch.where(el < 5.0, 0.6, 0.5))
    lane_done = lane_active & (el > 7.0)
    ov_state = torch.where(lane_done, OV_NONE, ov_state)
    lane_active = lane_active & ~lane_done

    rev_active = ov_state == OV_REVERSE
    # Reverse phases: back up 3 s, retry the lanes 3-5 s, then teleport.
    rev_backing = rev_active & (el < 3.0)
    rev_retry = rev_active & (el >= 3.0) & (el <= 5.0)
    retry_found = rev_retry & either_ok
    ov_state = torch.where(retry_found, side, ov_state)
    ov_start = torch.where(retry_found, now, ov_start)
    teleport_request = rev_active & (el > 5.0) & ~retry_found
    ov_state = torch.where(teleport_request, OV_NONE, ov_state)
    rev_backing = rev_backing & ~retry_found
    lane_active = lane_active | retry_found

    overtake_active = (lane_active | rev_backing) & ~light_gate
    lane_override = overtake_active & lane_active

    # --- obstacle zones ---
    in_hard = obs_dist < hard_dist
    in_slow = ~in_hard & (obs_dist < slow_dist)
    in_caution = ~in_hard & ~in_slow & (obs_dist < caution_dist)
    hard_brake_force = torch.clamp(
        torch.clamp(1.0 - obs_dist / torch.clamp(hard_dist, min=0.1), min=0.3) * w.brake_factor,
        0.0, 1.0)
    slow_factor = (obs_dist - hard_dist) / torch.clamp(slow_dist - hard_dist, min=0.1)

    gas = torch.where(in_slow, torch.minimum(nn_gas, 0.15 + slow_factor * 0.2), nn_gas)
    gas = torch.where(in_caution, torch.clamp(gas, max=0.4), gas)

    # Intersection handling: suppress phantom brakes (the model's brake feeds
    # nothing else downstream), blend the hint.
    suppress = at_intersection & (nn_brake > 0.3) & ~in_hard
    gas = torch.where(suppress, torch.clamp(gas, min=0.45), gas)
    steer_pre = torch.where(suppress & (hint_mag > 0.05), 0.4 * steer_in + 0.6 * hint, steer_in)

    # --- one smoothing push; the branch selects its pre-smooth steer ---
    push_steer = torch.where(lane_override, ov_steer + hint * 0.2, steer_pre)
    smoothing, sm_steer, sm_gas = smooth_controls(ctrl.smoothing, push_steer, gas)

    steer_normal = torch.where(at_intersection & (hint_mag > 0.05), 0.6 * sm_steer + 0.4 * hint,
                               sm_steer)
    steer_normal = torch.clamp(steer_normal, -1.0, 1.0)
    gas_normal = torch.clamp(sm_gas, 0.0, 0.9)

    # --- anti-stall UNSTICK ---
    stopped_running = ctrl.stopped_start > T_NONE / 2
    new_stopped_start = torch.where(
        (speed_kmh < 1.0) & ~ctrl.waiting_for_traffic,
        torch.where(stopped_running, ctrl.stopped_start, now), T_NONE)
    stopped_duration = torch.where(new_stopped_start > T_NONE / 2, now - new_stopped_start, 0.0)
    # ~red_ahead: queued behind a red is not stalled (collect mode passes False).
    unstick = (stopped_duration > 3.0) & ~light_gate & ~overtake_active & ~in_hard & ~red_ahead
    unstick_throttle = torch.where(stopped_duration > 6.0, 0.85, 0.7)
    unstick_steer = torch.where(hint_mag > 0.05, torch.clamp(hint * 0.5, -0.5, 0.5), steer_normal)

    # --- banded speed governor ---
    deficit = (current_target - speed_kmh) / torch.clamp(current_target, min=1.0)
    bands = [
        in_curve & (speed_kmh > current_target + 8.0),
        in_curve & (speed_kmh > current_target + 3.0),
        speed_kmh > max_speed + 10.0,
        speed_kmh > max_speed + 5.0,
        speed_kmh > max_speed,
        speed_kmh > current_target + 5.0,
    ]
    gov_throttle = _select(
        bands + [speed_kmh > current_target, speed_kmh < current_target * 0.4,
                 speed_kmh < current_target * 0.7, speed_kmh < current_target],
        [0.0] * 6 + [0.1, torch.clamp(gas_normal, min=0.8), torch.clamp(gas_normal, min=0.6),
                     torch.maximum(gas_normal, 0.3 + deficit * 0.35)],
        gas_normal)
    gov_brake = _select(bands, [0.4, 0.2, 0.9, 0.6, 0.4, 0.15], torch.zeros_like(speed_kmh))
    gov_brake = torch.where(gov_brake > 0.0, torch.clamp(gov_brake * w.brake_factor, 0.0, 1.0), 0.0)

    # Traction control: cap launch throttle below the weather threshold.
    tc = (w.traction_control > 0.5) & (speed_kmh < w.traction_speed_threshold_kmh)
    gov_throttle = torch.where(tc, torch.clamp(gov_throttle, max=0.5), gov_throttle)

    # ------------------------------------------------------------------
    # Select the final control by priority (low -> high overrides).
    # ------------------------------------------------------------------
    steer_f = torch.where(unstick, unstick_steer, steer_normal)
    thr_f = torch.where(unstick, unstick_throttle, gov_throttle)
    brk_f = torch.where(unstick, 0.0, gov_brake)
    status = torch.where(unstick, ST_UNSTICK, ST_OK)

    # Hard obstacle brake.
    steer_f = torch.where(in_hard, steer_normal, steer_f)
    thr_f = torch.where(in_hard, 0.0, thr_f)
    brk_f = torch.where(in_hard, hard_brake_force, brk_f)
    status = torch.where(in_hard, ST_BRAKE, status)

    # Overtake / reverse override; the overtake's steer is the smoothed
    # (ov_steer + hint*0.2), clipped to +/-0.5.
    steer_f = torch.where(lane_override, torch.clamp(sm_steer, -0.5, 0.5), steer_f)
    thr_f = torch.where(lane_override, ov_throttle, thr_f)
    brk_f = torch.where(lane_override, 0.0, brk_f)
    status = torch.where(lane_override,
                         torch.where(ov_state == OV_LEFT, ST_OVERTAKE_L, ST_OVERTAKE_R), status)
    steer_f = torch.where(rev_backing, torch.clamp(-hint * 0.3, -0.5, 0.5), steer_f)
    thr_f = torch.where(rev_backing, 0.4, thr_f)
    brk_f = torch.where(rev_backing, 0.0, brk_f)
    status = torch.where(rev_backing, ST_REVERSE, status)

    # Lights take absolute priority.
    steer_f = torch.where(light_gate, sm_steer, steer_f)
    thr_f = torch.where(light_gate, 0.0, thr_f)
    brk_f = torch.where(
        red, torch.clamp(0.8 * w.brake_factor, 0.0, 1.0),
        torch.where(yellow_stop, torch.clamp(0.5 * w.brake_factor, 0.0, 1.0), brk_f))
    reverse = rev_backing & ~light_gate
    status = torch.where(yellow_stop, ST_YELLOW, status)
    status = torch.where(red, ST_RED, status)

    # ------------------------------------------------------------------
    # State bookkeeping + events
    # ------------------------------------------------------------------
    entering_wait = (in_hard | in_slow) & ~light_gate & ~overtake_active & ~red_ahead

    def wait_clock(start):
        return torch.where(entering_wait, torch.where(start > T_NONE / 2, start, now), T_NONE)

    new_ctrl = CtrlState(
        smoothing=smoothing,
        waiting_for_red=red,
        red_clear_time=torch.where(light_gate, ctrl.red_clear_time, now),
        waiting_for_traffic=entering_wait,
        traffic_wait_start=wait_clock(ctrl.traffic_wait_start),
        obstacle_wait_start=wait_clock(ctrl.obstacle_wait_start),
        stopped_start=new_stopped_start,
        ov_state=ov_state,
        ov_start=ov_start,
    )
    control = torch.stack([torch.clamp(steer_f, -1.0, 1.0), torch.clamp(thr_f, 0.0, 1.0),
                           torch.clamp(brk_f, 0.0, 1.0)], dim=-1)
    events = {
        "red_light_stop": red & ~ctrl.waiting_for_red,
        "obstacle_brake": in_hard & ~light_gate & ~overtake_active,
        "teleport_request": teleport_request,
    }
    return control, reverse, status, new_ctrl, events


# ---------------------------------------------------------------------------
# The entry point: the cascade replayed from a CUDA graph on the card
# ---------------------------------------------------------------------------

# The world's fields the cascade reads; a graph copies in these alone and
# captures on a world whose other fields are None, so a read of one fails at
# the capture instead of baking in a stale tensor.
_WORLD_READS = ("veh_pos", "veh_alive", "ped_pos", "ped_alive", "time_s", "weather_idx")
_WORLD_UNREAD = {f.name: None for f in dataclasses.fields(WorldState)
                 if f.name not in _WORLD_READS}

_GRAPH = span("safety_graph")
_CAPTURE = span("safety_capture")


class _Captured(NamedTuple):
    """A capture of the cascade, with the network and weather table whose
    tensors it reads by address (held so that their memory is not reused
    while the graph lives). ``graph.out`` is (flat, layout, event names):
    the outputs packed as bytes in one buffer, and where each lies in it."""

    net: RoadNetwork
    wt: WeatherTable
    graph: Graph


# The captures, by ``graph_key``, for every caller in the process.
GRAPHS: dict[tuple, _Captured] = {}


def graph_inputs(world: WorldState, ctrl: CtrlState, *obs: torch.Tensor) -> tuple:
    """The tensors a graph of the cascade copies in: the world's fields it
    reads, ``ctrl``'s leaves, then the controls and observations (``obs``,
    ``safety_controller``'s arguments from ``nn_steer`` on)."""
    return (*(getattr(world, f) for f in _WORLD_READS), *tree_leaves(ctrl), *obs)


def graphable(inputs) -> bool:
    """Whether a call may replay a graph: every input on the card, none
    requiring grad."""
    return all(x.is_cuda and not x.requires_grad for x in inputs)


def graph_key(net: RoadNetwork, wt: WeatherTable, inputs: tuple) -> tuple:
    """What a captured graph holds fixed: the device, every input's shape
    and dtype, and the network and weather table whose tensors it reads."""
    return (inputs[0].device, tuple((x.shape, x.dtype) for x in inputs), id(net), id(wt))


def _pack(leaves: list):
    """The tensors ``leaves`` as bytes in one buffer, grouped by dtype, the
    widest elements first (so each group lies aligned to its element), and
    the layout: per group (dtype, start byte, stop byte, the leaves' indices,
    their sizes, their shapes where not 1-D)."""
    groups: dict = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    layout, parts, at = [], [], 0
    for dtype, idx in sorted(groups.items(), key=lambda g: -g[0].itemsize):
        sizes = [leaves[i].numel() for i in idx]
        shapes = [None if leaves[i].dim() == 1 else leaves[i].shape for i in idx]
        layout.append((dtype, at, at + sum(sizes) * dtype.itemsize, idx, sizes, shapes))
        parts += [leaves[i].reshape(-1).view(torch.uint8) for i in idx]
        at = layout[-1][2]
    return torch.cat(parts), layout


def _packed_cascade(net: RoadNetwork, wt: WeatherTable, ctrl: CtrlState):
    """The cascade as a function of ``graph_inputs`` (``ctrl`` gives their
    structure) returning its outputs packed by ``_pack``."""
    n_world, n_ctrl = len(_WORLD_READS), len(tree_leaves(ctrl))

    def run(*inputs):
        world = WorldState(**_WORLD_UNREAD, **dict(zip(_WORLD_READS, inputs[:n_world])))
        c = tree_unflatten(ctrl, inputs[n_world:n_world + n_ctrl])
        control, reverse, status, new_ctrl, events = safety_cascade(
            net, world, c, wt, *inputs[n_world + n_ctrl:])
        flat, layout = _pack([control, reverse, status, *tree_leaves(new_ctrl),
                              *events.values()])
        return flat, layout, tuple(events)

    return run


def _unpacked(ctrl: CtrlState, flat: torch.Tensor, layout: list, names: tuple):
    """The cascade's outputs as views of ``flat``, the buffer that
    ``_packed_cascade`` packs them in (``ctrl`` gives the new CtrlState's
    structure, ``names`` the events')."""
    out = [None] * sum(len(group[3]) for group in layout)
    for dtype, a, b, idx, sizes, shapes in layout:
        for i, x, shape in zip(idx, flat[a:b].view(dtype).split(sizes), shapes):
            out[i] = x if shape is None else x.view(shape)
    n_ctrl = len(out) - 3 - len(names)
    return (out[0], out[1], out[2], tree_unflatten(ctrl, out[3:3 + n_ctrl]),
            dict(zip(names, out[3 + n_ctrl:])))


@span("safety")
def safety_controller(
    net: RoadNetwork,
    world: WorldState,
    ctrl: CtrlState,
    wt: WeatherTable,
    nn_steer: torch.Tensor,  # [E] raw model outputs
    nn_gas: torch.Tensor,
    nn_brake: torch.Tensor,
    speed_kmh: torch.Tensor,
    cmd: torch.Tensor,  # [E] int high-level command
    hint: torch.Tensor,  # [E] steer hint from the route
    obs_dist: torch.Tensor,  # [E] m (999 = none)
    tl_state: torch.Tensor,  # [E] int traffic-light state
    red_ahead: torch.Tensor,  # [E] bool — queued behind a red
):
    """``safety_cascade``'s outputs, fresh tensors each call, replayed from a
    CUDA graph of it where ``graphable`` holds.

    The cascade is a few hundred small operations, which at a fleet's batch
    take the host longer to issue than the card to run. So on the card, with
    no input requiring grad, it is captured once for each ``graph_key`` (in
    ``GRAPHS``) and replayed on every later call: the inputs are copied into
    the graph's static buffers, the graph replays the same kernels in the
    same order, and its outputs, packed in one buffer inside the graph, are
    cloned out at once and viewed. Every other call runs the cascade
    eagerly: on the CPU, with an input requiring grad, and for a new
    signature while a ``torch.profiler`` runs (nothing is captured under
    one). A replay reads the network's and the weather table's tensors where
    they were at capture, so their updates in place carry over to it.

    Spans: ``safety_graph`` around each replay, with the copies in and the
    clone out; ``safety_capture`` around each capture, its warm-up included.
    """
    obs = (nn_steer, nn_gas, nn_brake, speed_kmh, cmd, hint, obs_dist, tl_state, red_ahead)
    inputs = graph_inputs(world, ctrl, *obs)
    if not graphable(inputs):
        return safety_cascade(net, world, ctrl, wt, *obs)
    key = graph_key(net, wt, inputs)
    g = GRAPHS.get(key)
    if g is None:
        if profiler_running():
            return safety_cascade(net, world, ctrl, wt, *obs)
        with _CAPTURE:
            g = GRAPHS[key] = _Captured(net, wt, capture(_packed_cascade(net, wt, ctrl), *inputs))
    with _GRAPH:
        flat, layout, names = replay(g.graph, inputs, "cilrs_safety_graph")
        return _unpacked(ctrl, flat.clone(), layout, names)
