"""NPC traffic AI: waypoint-following with spacing and light compliance (port
of ``cilrs_tpu/agent/npc.py``), over every NPC of every env at once.

Pure-pursuit steering along the lane graph, car-following deceleration
against the nearest leader in the forward corridor, red/yellow light stops,
junction yielding, plus the pedestrians' random re-aim.

The pedestrian re-aim is split into a draw and an apply:
``draw_pedestrians`` takes one uniform u in [0, 1) per pedestrian per tick from
an explicit ``torch.Generator``, and ``pedestrian_step_targets`` is the pure
function of (world, u). The JAX function draws its turn and its turn/no-turn
coin from the SAME key (``npc.py:146-151``), so both come from one uniform: a
pedestrian turns only when u < 0.02, and then always by about -0.29 rad. That
is a fault of the reference, reproduced here on purpose for parity; the tests
feed the JAX package's own u to the apply.
"""

from __future__ import annotations

import torch

from cilrs_tpu_torch.core.geometry import heading_vec, norm, wrap_angle
from cilrs_tpu_torch.core.state import WorldState
from cilrs_tpu_torch.maps.network import LIGHT_RED, LIGHT_YELLOW, RoadNetwork
from cilrs_tpu_torch.utils.profiling import span

WP_REACH_DIST = 3.0
# Gaps are center-to-center; two 4.7 m cars touch at ~4.6 m, and stopping from
# the 21 km/h flow takes ~2.6 m — the stop gap must cover both.
LEAD_GAP_STOP = 9.0
LEAD_GAP_SLOW = 18.0
LIGHT_STOP_DIST = 12.0
PED_TURN_MIN, PED_TURN_MAX, PED_TURN_P = -0.3, 0.3, 0.02

_U32 = 0xFFFFFFFF


def _advance_waypoints(net: RoadNetwork, pos: torch.Tensor, wp: torch.Tensor, salt: torch.Tensor):
    """Advance each vehicle's waypoint when reached; hashed successor choice.

    The successor pick hashes (waypoint, per-vehicle salt) as the JAX function
    does in uint32 arithmetic (here in int64, masked to 32 bits), so it is
    deterministic for a rollout but varied across vehicles.
    """
    target = net.wp_xy[wp]  # [E, V, 2]
    reached = norm(target - pos) < WP_REACH_DIST
    n = torch.clamp(net.wp_num_next[wp], min=1)
    h = ((wp * 2654435761 + salt) & _U32) >> 16
    choice = h % n
    nxt = net.wp_next[wp, choice]
    return torch.where(reached, nxt, wp)


@span("npc")
def npc_controller(net: RoadNetwork, world: WorldState, light_state: torch.Tensor):
    """Controls [E, V, 3] for every vehicle slot (the ego slot 0 returns zeros;
    the driver overwrites it), plus advanced waypoint indices [E, V].
    light_state is [E, L]."""
    E, V = world.veh_yaw.shape
    dev = world.veh_pos.device
    pos = world.veh_pos
    yaw = world.veh_yaw
    speed = world.veh_speed

    salt = (torch.arange(V, dtype=torch.int64, device=dev) * 40503 & _U32) ^ 0x9E3779B9
    wp = _advance_waypoints(net, pos, world.veh_wp, salt)

    # Pure pursuit toward the midpoint of the waypoint and its successor.
    look = net.wp_next[wp, 0]
    target = 0.5 * (net.wp_xy[wp] + net.wp_xy[look])
    to_t = target - pos
    desired = torch.atan2(to_t[..., 1], to_t[..., 0])
    err = wrap_angle(desired - yaw)
    steer = torch.clamp(err * 1.8, -1.0, 1.0)

    # Leader gap: nearest alive actor in my forward corridor.
    fwd = heading_vec(yaw)  # [E, V, 2]
    rel = pos[:, None, :, :] - pos[:, :, None, :]  # [E, me, other, 2]
    lon = rel[..., 0] * fwd[:, :, None, 0] + rel[..., 1] * fwd[:, :, None, 1]
    lat = rel[..., 1] * fwd[:, :, None, 0] - rel[..., 0] * fwd[:, :, None, 1]
    same = torch.eye(V, dtype=torch.bool, device=dev)
    blocking = (
        world.veh_alive[:, None, :]
        & ~same
        & (lon > 0.0)
        & (lon < 40.0)
        & (lat.abs() < 2.2)
    )
    lead_gap = torch.where(blocking, lon, 1e6).amin(dim=2)  # [E, V]

    # Pedestrians block too.
    relp = world.ped_pos[:, None, :, :] - pos[:, :, None, :]
    lonp = relp[..., 0] * fwd[:, :, None, 0] + relp[..., 1] * fwd[:, :, None, 1]
    latp = relp[..., 1] * fwd[:, :, None, 0] - relp[..., 0] * fwd[:, :, None, 1]
    blockp = world.ped_alive[:, None, :] & (lonp > 0.0) & (lonp < 25.0) & (latp.abs() < 2.2)
    lead_gap = torch.minimum(lead_gap, torch.where(blockp, lonp, 1e6).amin(dim=2))

    # Traffic lights: stop if the light governing MY approach lane is
    # red/yellow (lane-based gating, as in perception).
    if net.num_lights > 0:
        to_l = net.light_xy[None, None, :, :] - pos[:, :, None, :]  # [E, V, L, 2]
        lfwd = heading_vec(net.light_yaw)  # [L, 2]
        align = torch.cos(yaw)[..., None] * torch.cos(net.light_yaw) + \
            torch.sin(yaw)[..., None] * torch.sin(net.light_yaw)
        lon_l = -(to_l[..., 0] * lfwd[:, 0] + to_l[..., 1] * lfwd[:, 1])
        lat_l = (to_l[..., 0] * lfwd[:, 1] - to_l[..., 1] * lfwd[:, 0]).abs()
        stopgo = (light_state == LIGHT_RED) | (light_state == LIGHT_YELLOW)  # [E, L]
        gate = (
            (lon_l >= -LIGHT_STOP_DIST) & (lon_l <= 1.0) & (lat_l <= 3.0)
            & (align >= 0.5) & stopgo[:, None, :]
        )
        red_gate = gate.any(dim=2)
    else:
        red_gate = torch.zeros((E, V), dtype=torch.bool, device=dev)

    # Junction conflict handling: slow down inside junctions, and yield while
    # turning left when any moving vehicle converges within the horizon.
    in_junction = net.wp_is_junction[wp]
    turning_left = net.wp_turn[wp] == 1
    vel = heading_vec(yaw) * speed[..., None]  # [E, V, 2]
    conflict = torch.zeros((E, V), dtype=torch.bool, device=dev)
    # Only conflicts with actors that are actually moving (else deadlock).
    moving = world.veh_speed.abs()[:, None, :] > 0.8
    for horizon in (0.6, 1.2):
        pi = pos + vel * horizon  # [E, V, 2]
        dd = norm(pi[:, None, :, :] - pi[:, :, None, :])
        close = (dd < 3.5) & world.veh_alive[:, None, :] & ~same
        conflict = conflict | (close & moving).any(dim=2)
    yield_now = turning_left & in_junction & conflict

    # Longitudinal control: P-control to target speed with gap/light overrides.
    v_err = world.veh_target_speed - speed
    junction_cap = torch.where(in_junction, 15.0 / 3.6, 1e9)
    v_err = torch.minimum(v_err, junction_cap - speed)
    throttle = torch.clamp(v_err * 0.5, 0.0, 0.75)
    brake = torch.clamp(-v_err * 0.4, 0.0, 0.5)
    slow = lead_gap < LEAD_GAP_SLOW
    throttle = torch.where(slow, torch.clamp(throttle, max=0.2), throttle)
    stop = (lead_gap < LEAD_GAP_STOP) | red_gate | yield_now
    throttle = torch.where(stop, 0.0, throttle)
    brake = torch.where(stop, 0.8, brake)

    controls = torch.stack([steer, throttle, brake], dim=-1)
    ego = torch.arange(V, device=dev) == 0
    controls = torch.where(ego[None, :, None], 0.0, controls)  # ego slot: the driver's
    return controls, wp


def draw_pedestrians(generator: torch.Generator, steps: int, num_envs: int,
                     num_pedestrians: int, device) -> torch.Tensor:
    """The pedestrians' re-aim draws for ``steps`` ticks: uniforms [T, E, P]
    in [0, 1), one per pedestrian per tick."""
    return torch.rand((steps, num_envs, num_pedestrians), generator=generator,
                      dtype=torch.float32, device=device)


def pedestrian_step_targets(world: WorldState, u: torch.Tensor) -> torch.Tensor:
    """Re-aim pedestrians: small random heading drift (walker AI). u [E, P] is
    the tick's uniform draw; the turn and the turn/no-turn coin both derive
    from it, as ``jax.random.uniform`` derives both from one key."""
    turn = torch.clamp(u * (PED_TURN_MAX - PED_TURN_MIN) + PED_TURN_MIN, min=PED_TURN_MIN)
    do_turn = u < PED_TURN_P
    return torch.where(do_turn, world.ped_yaw + turn, world.ped_yaw)
