"""Autopilot teacher: the route-following expert used for data collection (port
of ``cilrs_tpu/agent/autopilot.py``), for every env at once.

Curvature feedforward + deadbanded Stanley-style correction for steering,
piecewise-constant speed plateaus, obstacle and traffic-light gating. Its
outputs drive the ego AND are recorded as the behavior-cloning labels. The
JAX module's comments give the measurements behind each constant.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.core.geometry import take, wrap_angle
from portbench.reference.frozen.maps.network import LIGHT_RED, LIGHT_YELLOW
from portbench.reference.frozen.maps.routing import Route

TARGET_SPEED_KMH = 30.0  # reference collect_data.py Config.TARGET_SPEED
_PROJ_WINDOW = 6  # segments around route_idx searched for the closest point
WHEELBASE, MAX_STEER = 2.9, 0.6109  # core.state.default_vehicle_params


def _localize_continuous(route: Route, route_idx: torch.Tensor, pos: torch.Tensor):
    """Fractional route position + tracking errors: project pos [E, 2] onto the
    polyline segments around route_idx [E].

    Returns (s, e_lat, chord_yaw, seg_len), each [E]: fractional index, signed
    lateral offset from the route (left +), the chord heading and length of
    the closest segment."""
    last = route.length - 1
    offs = torch.arange(-2, _PROJ_WINDOW, device=route_idx.device)
    cand = torch.minimum(torch.clamp(route_idx[:, None] + offs, min=0), (last - 1)[:, None])
    a = take(route.xy, cand)  # [E, 8, 2]
    b = take(route.xy, torch.minimum(cand + 1, last[:, None]))
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-8)
    t = torch.clamp(torch.sum((pos[:, None] - a) * ab, dim=-1) / denom, 0.0, 1.0)
    p = a + t[..., None] * ab
    d2 = torch.sum((p - pos[:, None]) ** 2, dim=-1)
    k = torch.argmin(d2, dim=1, keepdim=True)  # [E, 1]
    abk = take(ab, k)[:, 0]
    seg_len = torch.sqrt(torch.sum(abk * abk, dim=-1) + 1e-12)
    tang = abk / seg_len[:, None]
    rel = pos - take(a, k)[:, 0]
    e_lat = tang[:, 0] * rel[:, 1] - tang[:, 1] * rel[:, 0]  # left of route +
    chord_yaw = torch.atan2(tang[:, 1], tang[:, 0])
    s = torch.gather(cand, 1, k)[:, 0].to(torch.float32) + torch.gather(t, 1, k)[:, 0]
    return s, e_lat, chord_yaw, seg_len


def _interp_route(route: Route, s: torch.Tensor) -> torch.Tensor:
    """Point on each env's route polyline at fractional index s [E]."""
    last = route.length - 1
    s = torch.minimum(torch.clamp(s, min=0.0), last.to(torch.float32))
    i0 = torch.floor(s).to(torch.int64)
    frac = s - i0.to(torch.float32)
    return (take(route.xy, i0) * (1.0 - frac[:, None])
            + take(route.xy, torch.minimum(i0 + 1, last)) * frac[:, None])


def _db(x, band):
    return torch.sign(x) * torch.clamp(x.abs() - band, min=0.0)


def autopilot_controls(
    route: Route,
    route_idx: torch.Tensor,  # [E]
    pos: torch.Tensor,  # [E, 2]
    yaw: torch.Tensor,
    speed_kmh: torch.Tensor,
    obs_dist: torch.Tensor,
    tl_state: torch.Tensor,
    target_speed_kmh: float = TARGET_SPEED_KMH,
):
    """Returns (steer, throttle, brake) [E] in the same ranges the model learns."""
    last = route.length - 1
    lastf = last.to(torch.float32)

    # Steering = curvature FEEDFORWARD + DEADBANDED Stanley-style correction.
    sel, e_lat, chord_yaw, seg_len = _localize_continuous(route, route_idx, pos)
    s = torch.minimum(torch.clamp(sel, min=0.0), lastf)
    i = torch.floor(s).to(torch.int64)
    frac = s - i.to(torch.float32)

    kappa = (take(route.kappa, torch.minimum(i, last)) * (1.0 - frac)
             + take(route.kappa, torch.minimum(i + 1, last)) * frac)
    steer_ff = torch.atan(WHEELBASE * kappa) / MAX_STEER

    # Single heading loop toward the route; exactly 0 at perfect tracking.
    v_ms = torch.clamp(speed_kmh / 3.6, min=2.0)
    # The chord equals the true tangent at the segment MIDPOINT.
    tang_yaw = chord_yaw + (frac - 0.5) * kappa * seg_len
    psi_err = wrap_angle(tang_yaw - yaw) + torch.atan(-0.9 * e_lat / v_ms)
    # Wider deadband inside corner arcs.
    band = torch.where(steer_ff.abs() > 0.08, 0.06, 0.02)
    corr = torch.clamp(0.8 * _db(psi_err, band), -0.5, 0.5)
    steer = torch.clamp(steer_ff + corr, -1.0, 1.0)

    # Upcoming-turn awareness: the 18 km/h intersection plateau on a sharp bend.
    ahead_yaw = take(route.yaw, torch.minimum(i + 6, last))
    bend = wrap_angle(ahead_yaw - take(route.yaw, torch.minimum(i, last))).abs()
    target = torch.where(bend > 0.3, 18.0, target_speed_kmh)

    # Speed control: saturating high-gain law.
    band = 5.0  # km/h: linear strip below target where throttle feathers out
    v_gap = target - speed_kmh
    throttle = 0.62 * torch.clamp(v_gap / band, 0.0, 1.0)
    brake = 0.5 * torch.clamp((-v_gap - 1.0) / 3.0, 0.0, 1.0)

    # Transient ease-off when the TRACKING error is large at speed.
    corneriness = torch.clamp((psi_err.abs() - 0.2) * 5.0, 0.0, 1.0)
    fast = torch.clamp((speed_kmh - 14.0) / 8.0, 0.0, 1.0)
    throttle = throttle * (1.0 - corneriness * fast)
    brake = torch.maximum(brake, torch.clamp((psi_err.abs() - 0.5) * 2.0, 0.0, 1.0) * 0.3)

    # Obstacle gating: close-range follow with a plateau brake.
    gate = 7.0 + 0.25 * speed_kmh  # ~14.5 m at 30 km/h
    throttle = throttle * torch.clamp((obs_dist - gate) / 3.0, 0.0, 1.0)
    brake = torch.maximum(brake, 0.85 * torch.clamp((gate - obs_dist) / 3.0, 0.0, 1.0))

    # Traffic lights: stop on red, and on yellow when still slow enough.
    red = tl_state == LIGHT_RED
    yellow_stop = (tl_state == LIGHT_YELLOW) & (speed_kmh < 30.0)
    stop = red | yellow_stop
    throttle = torch.where(stop, 0.0, throttle)
    brake = torch.where(stop, 0.8, brake)

    return steer, torch.clamp(throttle, 0.0, 1.0), torch.clamp(brake, 0.0, 1.0)
