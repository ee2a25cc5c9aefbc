"""The rasterizer: a per-pixel raycast of each env's world into an RGB frame
(port of ``cilrs_tpu/render/raster.py``).

``render_frame(net, world, light_state) -> [E, H, W, 3] float32`` renders the
ego camera of every env at once: on CUDA tensors in the hand-written kernels
of ``csrc/render.cu`` (``ops/render.py``; about 8 launches, the sin hashes
among them), on CPU tensors in torch ops (``render_frame_plain``, which the
JAX parity tests hold); on the card the kernels give the torch ops' frame
bit for bit. Geometry is analytic, as in the JAX package:
 - ground plane z=0 classified against the K lane segments nearest the ego
   (road / lane-marking / sidewalk -> asphalt / paint / pavement / grass);
 - vehicles and the nearest buildings as vertical oriented boxes (slab test
   in each box's frame), in one merged pass;
 - pedestrians as vertical cylinders;
 - traffic lights as poles + emissive state-colored heads (K nearest);
 - procedural weather on top (fog, rain streaks, night headlight cone), then
   the speed-dependent zoom blur.

Numerics follow the JAX function where they decide what a pixel shows:
 - the [pixels x K] ground classification runs in bf16 with the same casts;
 - the box solve is materialised in bf16 before its reductions, and INF is
   restored for all-miss pixels;
 - the K nearest waypoints, buildings and lights are selected with a stable
   sort, which breaks distance ties toward the lower index as
   ``jax.lax.top_k`` does (the set matters: the dash cadence is idx % 3, and
   the maps' symmetric layouts tie distances exactly);
 - the hashes of the ground grain and the rain streaks take glibc's
   ``sinf`` of an argument rounded as XLA's fused multiply-add rounds it, as
   jitted ``jnp.sin`` does on XLA:CPU, and the grain's two scales are summed
   as XLA contracts the sum (``ops/sinf.py:grain_texture``, ``hash01``).

The JAX package's opt-in switches, read when the module is imported and off
by default (the measured-best render): ``CILRS_TPU_LAMPS=1`` lights a braking
NPC's taillights (brake > 0.45; ``CILRS_TPU_NO_LAMPS=1`` vetoes it),
``CILRS_TPU_NIGHT_LAMPS=1`` dim constant taillights at night
(``CILRS_TPU_NO_NIGHT_LAMPS=1`` vetoes it), ``CILRS_TPU_CROSSWALKS=1`` stop
bars and zebra crossings at the K nearest lights, an [pixels x K] pass in
bf16 like the ground classification.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from cilrs_tpu_torch.core.geometry import const, take
from cilrs_tpu_torch.core.state import WorldState
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.ops import render as kernels
from cilrs_tpu_torch.ops.sinf import grain_hash, grain_texture
from cilrs_tpu_torch.render import weather as wx
from cilrs_tpu_torch.render.camera import CameraSpec, camera_position, pixel_coords, ray_directions
from cilrs_tpu_torch.utils.profiling import span

CAMERA = CameraSpec()

VEH_HEIGHT = 1.55
PED_RADIUS = 0.35
PED_HEIGHT = 1.8
LIGHT_POLE_H = 5.2
LIGHT_HEAD_R = 0.5
NUM_NEAR_LIGHTS = 8
NUM_NEAR_BUILDINGS = 10
NUM_NEAR_SEGMENTS = 72  # lane segments culled around the ego per frame

INF = 1e9

# Muted facade palette (index-hashed per building).
_BLDG_COLORS = (
    (0.58, 0.52, 0.45),
    (0.63, 0.58, 0.50),
    (0.48, 0.42, 0.38),
    (0.66, 0.60, 0.55),
    (0.55, 0.48, 0.40),
    (0.70, 0.64, 0.52),
    (0.52, 0.50, 0.46),
)
# Small palette so NPC vehicles are visually distinct.
_VEH_COLORS = (
    (0.62, 0.12, 0.12),
    (0.12, 0.20, 0.55),
    (0.80, 0.80, 0.82),
    (0.15, 0.15, 0.17),
    (0.70, 0.55, 0.15),
    (0.25, 0.45, 0.28),
    (0.55, 0.30, 0.55),
    (0.85, 0.45, 0.10),
)
_GRASS = (0.22, 0.34, 0.16)
_SIDEWALK = (0.52, 0.50, 0.48)
_ASPHALT = (0.23, 0.23, 0.24)
_MARKING = (0.85, 0.85, 0.80)
_TAILLIGHT = (0.95, 0.07, 0.05)

_LAMPS = (os.environ.get("CILRS_TPU_LAMPS", "") == "1"
          and os.environ.get("CILRS_TPU_NO_LAMPS", "") != "1")
_NIGHT_LAMPS = (os.environ.get("CILRS_TPU_NIGHT_LAMPS", "") == "1"
                and os.environ.get("CILRS_TPU_NO_NIGHT_LAMPS", "") != "1")
_CROSSWALKS = os.environ.get("CILRS_TPU_CROSSWALKS", "") == "1"
_POLE = (0.25, 0.26, 0.28)
_PED_COLOR = (0.55, 0.35, 0.25)
_LIGHT_COLORS = (
    (0.1, 0.95, 0.2),   # green
    (0.95, 0.8, 0.1),   # yellow
    (0.95, 0.1, 0.1),   # red
    (0.4, 0.4, 0.4),    # none/off
)

ROAD_HALF_W = 2.2  # m from a lane centerline (lanes 3.5 m, centers 3.5 m apart)
SIDEWALK_OUT = 4.2
MARKING_LAT = 1.75  # road-center double line sits left of each lane center
MARKING_HALF_W = 0.22


def _bf16(v: float) -> float:
    """v rounded to bfloat16, as the JAX function writes its bf16 constants."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


_BF_MARKING_LAT = _bf16(MARKING_LAT)
_BF_MARKING_HALF_W = _bf16(MARKING_HALF_W)
_BF_INF = _bf16(INF)  # bf16(INF) rounds below the float32 INF sentinel


def _color(rgb: tuple, device) -> torch.Tensor:
    return const(rgb, torch.float32, device)


def nearest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest of d2 [E, M] per row, ties to the lower index
    (``jax.lax.top_k(-d2, k)``); ``torch.topk`` promises no tie order."""
    return torch.sort(d2, dim=-1, stable=True).indices[:, :k]


def _safe_div(a, b):
    return a / torch.where(b.abs() < 1e-7, torch.where(b >= 0, 1e-7, -1e-7), b)


def _ground_masks(net: RoadNetwork, ego_pos: torch.Tensor, gxy: torch.Tensor):
    """Analytic ground classification against the K lane segments nearest
    each ego: ego_pos [E, 2], ground points gxy [E, N, 2].

    Returns (road, marking, sidewalk) float masks [E, N].
    """
    d2 = torch.sum((net.wp_xy - ego_pos[:, None]) ** 2, dim=-1)  # [E, W]
    idx = nearest_k(d2, NUM_NEAR_SEGMENTS)  # [E, K]
    a = net.wp_xy[idx]  # [E, K, 2]
    b = net.wp_xy[net.wp_next[idx, 0]]
    junction = net.wp_is_junction[idx]
    dash_on = (idx % 3) != 2  # same 2-on/1-off cadence as the map texture

    ab = b - a
    seg_len = torch.sqrt(torch.sum(ab * ab, dim=-1) + 1e-9)  # [E, K]
    dirn = ab / seg_len[..., None]

    # bf16 for the [N, K] loop, as the JAX function: ego-centered
    # coordinates keep magnitudes < ~150 m.
    bf = torch.bfloat16
    g16 = (gxy - ego_pos[:, None]).to(bf)  # [E, N, 2]
    a16 = (a - ego_pos[:, None]).to(bf)  # [E, K, 2]
    dx16 = dirn[:, None, :, 0].to(bf)  # [E, 1, K]
    dy16 = dirn[:, None, :, 1].to(bf)
    len16 = seg_len[:, None, :].to(bf)

    relx = g16[..., 0:1] - a16[:, None, :, 0]  # [E, N, K]
    rely = g16[..., 1:2] - a16[:, None, :, 1]
    s = relx * dx16 + rely * dy16  # along-track
    t = torch.minimum(torch.clamp(s, min=0.0), len16)
    lat = rely * dx16 - relx * dy16  # signed, left +
    dx = relx - t * dx16
    dy = rely - t * dy16
    d2px = dx * dx + dy * dy  # [E, N, K] squared distance

    dmin = torch.sqrt(torch.amin(d2px, dim=-1).to(torch.float32) + 1e-12)  # [E, N]
    road = (dmin < ROAD_HALF_W).to(torch.float32)
    sidewalk = ((dmin >= ROAD_HALF_W) & (dmin < SIDEWALK_OUT)).to(torch.float32)
    on_marking = (
        ((lat - _BF_MARKING_LAT).abs() < _BF_MARKING_HALF_W)
        & (s > 0) & (s < len16)
        & (dash_on & ~junction)[:, None, :]
    )
    marking = on_marking.any(dim=-1).to(torch.float32) * road
    return road, marking, sidewalk


def _junction_markings(net: RoadNetwork, ego_pos: torch.Tensor, gxy: torch.Tensor) -> torch.Tensor:
    """Stop bars and zebra crossings at the K lights nearest each ego (the
    ``CILRS_TPU_CROSSWALKS`` switch): ego_pos [E, 2], ground points gxy
    [E, N, 2]. One [N, K] pass in bf16, as the JAX function. Returns a [E, N]
    paint mask in {0, 1}."""
    L = net.num_lights
    if L == 0:
        return torch.zeros(gxy.shape[:-1], device=gxy.device)
    near = nearest_k(torch.sum((net.light_xy - ego_pos[:, None]) ** 2, dim=-1), min(NUM_NEAR_LIGHTS, L))
    lxy, lyaw = net.light_xy[near], net.light_yaw[near]  # [E, K, 2], [E, K]
    bf = torch.bfloat16
    fx, fy = torch.cos(lyaw)[:, None].to(bf), torch.sin(lyaw)[:, None].to(bf)  # [E, 1, K]
    rel_x = (gxy[..., 0:1] - lxy[:, None, :, 0]).to(bf)  # [E, N, K]
    rel_y = (gxy[..., 1:2] - lxy[:, None, :, 1]).to(bf)
    lon = rel_x * fx + rel_y * fy
    lat = rel_y * fx - rel_x * fy
    in_lane = lat.abs() <= _bf16(2.2)
    bar = (lon >= _bf16(-0.6)) & (lon <= 0.0) & in_lane  # the stop bar before the line
    zebra = torch.remainder(lat, _bf16(1.2)) < _bf16(0.6)  # stripes along the lane
    walk = (lon >= _bf16(0.6)) & (lon <= _bf16(2.2)) & (lat.abs() <= _bf16(2.6)) & zebra
    return (bar | walk).any(dim=-1).to(torch.float32)


def _motion_stretch(pxy: torch.Tensor, yaw: torch.Tensor, speed_ms: torch.Tensor) -> torch.Tensor:
    """Compress world points [E, N, 2] along each ego's travel direction by
    (1 + k*v) before hashing, so the value-noise cells render stretched along
    motion (the frame's main speed cue for the aux speed head)."""
    fwd = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)  # [E, 2]
    stretch = 1.0 + 0.11 * speed_ms.abs()
    along = torch.sum(pxy * fwd[:, None, :], dim=-1)  # [E, N]
    return pxy + fwd[:, None, :] * (along * (1.0 / stretch - 1.0)[:, None])[..., None]


# The JAX renderer's per-cell value noise at one cell size (its ``_hash2``);
# ``grain_texture`` computes both of the grain's sizes and their sum in one
# kernel launch.
_hash2 = grain_hash


def _ray_obb(oz: float, d, center_xy, yaw, half_l, half_w, height, lamps: bool = False):
    """Rays from (0, 0, oz) along d [E, N, 3] against vertical oriented boxes,
    centers [E, B, 2] relative to the camera, params [E, B].

    Returns (t_hit [E, N, B], shade [E, N, B]); t = INF on a miss. With
    ``lamps``, also the taillight mask [E, N, B] in {0, 1}: two bands at the
    outer corners of the rear face, at lamp height.
    """
    c, s = torch.cos(yaw)[:, None, :], torch.sin(yaw)[:, None, :]  # [E, 1, B]
    cx, cy = center_xy[:, None, :, 0], center_xy[:, None, :, 1]
    # Body frame: x fwd, y left.
    ox = (0.0 - cx) * c + (0.0 - cy) * s  # [E, 1, B]
    oy = -(0.0 - cx) * s + (0.0 - cy) * c
    dx = d[..., 0:1] * c + d[..., 1:2] * s  # [E, N, B]
    dy = -d[..., 0:1] * s + d[..., 1:2] * c
    dz = d[..., 2:3]  # [E, N, 1]
    half_l, half_w, height = half_l[:, None, :], half_w[:, None, :], height[:, None, :]

    t1x = _safe_div(-half_l - ox, dx)
    t2x = _safe_div(half_l - ox, dx)
    t1y = _safe_div(-half_w - oy, dy)
    t2y = _safe_div(half_w - oy, dy)
    t1z = _safe_div(torch.full_like(dz, 0.0 - oz), dz)
    t2z = _safe_div(height - oz, dz)

    tminx, tmaxx = torch.minimum(t1x, t2x), torch.maximum(t1x, t2x)
    tminy, tmaxy = torch.minimum(t1y, t2y), torch.maximum(t1y, t2y)
    tminz, tmaxz = torch.minimum(t1z, t2z), torch.maximum(t1z, t2z)
    tmin = torch.maximum(torch.maximum(tminx, tminy), tminz)
    tmax = torch.minimum(torch.minimum(tmaxx, tmaxy), tmaxz)
    hit = (tmax >= tmin) & (tmax > 0.0) & (tmin > 0.05)
    # Face shading by entry axis: side faces darker, top brightest.
    shade = torch.where(tmin == tminz, 1.0, torch.where(tmin == tminx, 0.72, 0.55))
    if not lamps:
        return torch.where(hit, tmin, INF), shade
    rear = hit & (tmin == tminx) & (dx > 0.0)  # entered through the rear face
    yfrac = (oy + tmin * dy).abs() / torch.clamp(half_w, min=1e-3)
    z_hit = oz + tmin * dz
    lamp = rear & (yfrac > 0.50) & (yfrac < 0.94) & (z_hit > 0.42) & (z_hit < 0.76)
    return torch.where(hit, tmin, INF), shade, lamp.to(torch.float32)


def _ray_cylinder(oz: float, d, center_xy, radius: float, height: float):
    """Rays from (0, 0, oz) along d [E, N, 3] against vertical cylinders with
    centers [E, P, 2] relative to the camera -> t [E, N, P]."""
    ox = 0.0 - center_xy[:, None, :, 0]  # [E, 1, P]
    oy = 0.0 - center_xy[:, None, :, 1]
    dx, dy = d[..., 0:1], d[..., 1:2]  # [E, N, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (dx * ox + dy * oy)
    cc = ox * ox + oy * oy - radius * radius
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.clamp(2.0 * a, min=1e-7)
    z = oz + t * d[..., 2:3]
    hit = (disc > 0.0) & (t > 0.05) & (z >= 0.0) & (z <= height)
    return torch.where(hit, t, INF)


def _ray_sphere(oz: float, d, center, radius: float):
    """Rays from (0, 0, oz) against spheres, centers [E, L, 3] -> t [E, N, L]."""
    oc = torch.cat([-center[..., :2], oz - center[..., 2:3]], dim=-1)  # [E, L, 3]
    b = 2.0 * torch.einsum("enk,elk->enl", d, oc)
    cc = torch.sum(oc * oc, dim=-1)[:, None, :] - radius * radius  # [E, 1, L]
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / 2.0
    hit = (disc > 0.0) & (t > 0.05)
    return torch.where(hit, t, INF)


_MB_SCALES = (0.94, 0.88)  # zoom-blur sample scales toward the FOE
_MB_SPEED_NORM = 36.0  # km/h at which blur weight saturates


def _zoom_axis(n: int, f: float) -> tuple:
    """A zoom's taps along an axis of n pixels scaled by f about its center:
    the lower and upper source index and the upper's weight (float32)."""
    c = (n - 1) / 2.0
    s = c + (np.arange(n) - c) * f
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n - 1)
    return i0, np.minimum(i0 + 1, n - 1), np.float32(s - i0)


def _zoom_sample(img: torch.Tensor, f: float) -> torch.Tensor:
    """Bilinear resample of img [E, H, W, 3] scaled by factor f about the
    image center; the coordinates are constants of (H, W, f)."""
    _, H, W, _ = img.shape
    dev = img.device
    y0, y1, fy = _zoom_axis(H, f)
    fy = const(tuple(fy.tolist()), torch.float32, dev)[:, None, None]
    ty0, ty1 = (const(tuple(a.tolist()), torch.int64, dev) for a in (y0, y1))
    rows = img[:, ty0] * (1.0 - fy) + img[:, ty1] * fy
    x0, x1, fx = _zoom_axis(W, f)
    fx = const(tuple(fx.tolist()), torch.float32, dev)[None, :, None]
    tx0, tx1 = (const(tuple(a.tolist()), torch.int64, dev) for a in (x0, x1))
    return rows[:, :, tx0] * (1.0 - fx) + rows[:, :, tx1] * fx


@functools.cache
def zoom_taps(height: int, width: int, device: torch.device) -> torch.Tensor:
    """The blur kernel's taps [2, 3 (H + W)] float32: for each of
    ``_MB_SCALES``, ``_zoom_sample``'s y0, y1, fy over the rows and x0, x1, fx
    over the columns."""
    rows = [np.concatenate([np.concatenate([a.astype(np.float32) for a in _zoom_axis(n, f)])
                            for n in (height, width)]) for f in _MB_SCALES]
    return torch.from_numpy(np.stack(rows)).to(device)


def motion_blur(img: torch.Tensor, speed_kmh: torch.Tensor) -> torch.Tensor:
    """Speed-dependent zoom blur about the focus of expansion (image center):
    img [E, H, W, 3], speed_kmh [E]. CARLA's RGB camera applies motion blur by
    default, so the reference's frames carry this speed cue. One kernel launch
    on CUDA tensors (``ops/render.py:render_blur``), ``motion_blur_plain`` on
    CPU tensors."""
    if img.device.type == "cuda":
        _, H, W, _ = img.shape
        # The blur's constants are the same for every camera.
        return kernels.render_blur(img, speed_kmh, zoom_taps(H, W, img.device),
                                   kernel_consts(CAMERA))
    return motion_blur_plain(img, speed_kmh)


def motion_blur_plain(img: torch.Tensor, speed_kmh: torch.Tensor) -> torch.Tensor:
    """``motion_blur`` in torch ops."""
    samples = [img] + [_zoom_sample(img, f) for f in _MB_SCALES]
    b = torch.clamp(speed_kmh / _MB_SPEED_NORM, 0.0, 1.0) * 0.85
    k = torch.arange(float(len(samples)), device=img.device)
    w = b[:, None] ** k  # [E, 3]
    w = w / torch.sum(w, dim=-1, keepdim=True)
    w = w[:, :, None, None, None]
    return w[:, 0] * samples[0] + w[:, 1] * samples[1] + w[:, 2] * samples[2]


@span("render")
def render_frame(
    net: RoadNetwork,
    world: WorldState,
    light_state: torch.Tensor,  # [E, L] from maps.network.light_states
    spec: CameraSpec = CAMERA,
    include_ego: bool = False,  # True for chase/spectator views
) -> torch.Tensor:
    """Render each env's camera. Returns [E, H, W, 3] float32 in [0, 1]. On
    CUDA tensors the kernels of ``csrc/render.cu`` (``render_frame_kernels``),
    which give ``render_frame_plain``'s frame on the card bit for bit; on CPU
    tensors the torch composition (``render_frame_plain``)."""
    if world.veh_pos.device.type == "cuda":
        return render_frame_kernels(net, world, light_state, spec, include_ego)
    return render_frame_plain(net, world, light_state, spec, include_ego)


@functools.cache
def kernel_consts(spec: CameraSpec):
    """The render kernels' constants for camera ``spec``, by the names that
    ``csrc/render.cu:RENDER_CONSTS`` gives them, each as
    ``render_frame_plain`` rounds it. A tensor divided by a
    Python number on the card is multiplied by the number's reciprocal, taken
    in double and rounded to float32, so the divisors go as those."""
    def recip(x: float) -> float:
        return float(np.float32(1.0 / x))

    pitch = math.radians(spec.pitch_deg)
    return kernels.pack_consts(dict(
        inv_w=recip(spec.width), inv_h=recip(spec.height), tan_h=spec.tan_half_fov,
        tan_v=spec.tan_half_fov * 0.75, cos_pitch=math.cos(pitch), sin_pitch=math.sin(pitch),
        offset_fwd=spec.offset_fwd, offset_up=spec.offset_up, far_plane=spec.far,
        road_half_w=ROAD_HALF_W, sidewalk_out=SIDEWALK_OUT, marking_lat=_BF_MARKING_LAT,
        marking_half_w=_BF_MARKING_HALF_W, inf=INF, bf_inf=_BF_INF,
        # _junction_markings' bounds
        cw_lane=_bf16(2.2), cw_bar=_bf16(-0.6), cw_walk0=_bf16(0.6), cw_walk1=_bf16(2.2),
        cw_walk_w=_bf16(2.6), cw_period=_bf16(1.2), cw_stripe=_bf16(0.6),
        veh_half_l=4.7 / 2, veh_half_w=2.0 / 2, veh_height=VEH_HEIGHT,
        # the poles: 0.12 m cylinders 2.4 m right of the stop line
        ped_r2=PED_RADIUS * PED_RADIUS, ped_height=PED_HEIGHT, pole_r2=0.12 * 0.12,
        pole_height=LIGHT_POLE_H, head_r2=LIGHT_HEAD_R * LIGHT_HEAD_R, pole_offset=2.4,
        # the sky's elevation / 0.6, the headlight's cone / 0.03 and falloff / 25
        inv_elev=recip(0.6), inv_cone=recip(0.03), inv_near=recip(25.0),
        inv_blur_speed=recip(_MB_SPEED_NORM), blur_peak=0.85, blur_exp=(0.0, 1.0, 2.0),
        grass=_GRASS, sidewalk=_SIDEWALK, asphalt=_ASPHALT, marking=_MARKING,
        taillight=_TAILLIGHT, pole=_POLE, ped=_PED_COLOR, light_colors=_LIGHT_COLORS,
        veh_colors=_VEH_COLORS, bldg_colors=_BLDG_COLORS, sky_top=wx._SKY_TOP,
        sky_horizon=wx._SKY_HORIZON, ambient=wx._AMBIENT, fog=wx._FOG_DENSITY, rain=wx._RAIN,
        wet=wx._WET, night=wx._NIGHT))


def render_frame_kernels(net: RoadNetwork, world: WorldState, light_state: torch.Tensor,
                         spec: CameraSpec = CAMERA, include_ego: bool = False) -> torch.Tensor:
    """``render_frame`` through the render kernels: the scene records, the
    ground points and rain columns, the sin hashes over them (called where
    ``render_frame_plain`` calls them), the frame, the blur and the clamp."""
    E, V, P = world.num_envs, world.num_vehicles, world.num_pedestrians
    num_wp, num_bldg, L = net.num_waypoints, net.bldg_xy.shape[0], net.num_lights
    segments = min(NUM_NEAR_SEGMENTS, num_wp)
    near_bldg, near_lights = min(NUM_NEAR_BUILDINGS, num_bldg), min(NUM_NEAR_LIGHTS, L)
    first_box = 0 if include_ego else 1
    dims = dict(envs=E, height=spec.height, width=spec.width, vehicles=V, walkers=P,
                waypoints=num_wp, max_next=net.wp_next.shape[1], buildings=num_bldg, lights=L,
                segments=segments, near_buildings=near_bldg, near_lights=near_lights,
                first_box=first_box, lamps=_LAMPS, night_lamps=_NIGHT_LAMPS,
                crosswalks=_CROSSWALKS,
                record=kernels.record_floats(segments, V - first_box + near_bldg, P, near_lights))
    consts = kernel_consts(spec)
    inputs = {name: getattr(world, name) for name in (
        "veh_pos", "veh_yaw", "veh_speed", "veh_alive", "veh_control", "veh_reverse", "ped_pos",
        "ped_alive", "time_s", "weather_idx")}
    inputs.update({name: getattr(net, name) for name in (
        "wp_xy", "wp_next", "wp_is_junction", "bldg_xy", "bldg_yaw", "bldg_half", "bldg_h",
        "light_xy", "light_yaw")}, light_state=light_state)
    records, speed_kmh = kernels.render_prep(inputs, dims, consts)
    sxy, cols, cols_t = kernels.render_points(records, dims, consts)
    tex = grain_texture(sxy)
    img = kernels.render_shade(records, tex, wx._hash01(cols), wx._hash01(cols_t), dims, consts)
    return torch.clamp(motion_blur(img, speed_kmh), 0.0, 1.0)


def render_frame_plain(
    net: RoadNetwork,
    world: WorldState,
    light_state: torch.Tensor,
    spec: CameraSpec = CAMERA,
    include_ego: bool = False,
) -> torch.Tensor:
    """``render_frame`` in torch ops, the render kernels' plain version."""
    H, W = spec.height, spec.width
    E = world.num_envs
    dev = world.veh_pos.device
    ego_pos, ego_yaw = world.ego_pos, world.ego_yaw
    widx = world.weather_idx
    o = camera_position(spec, ego_pos, ego_yaw)  # [E, 3]
    o_xy = o[:, :2]
    oz = torch.tensor(spec.offset_up, dtype=torch.float32).item()  # the same for every env
    rays = ray_directions(spec, ego_yaw).reshape(E, -1, 3)  # [E, N, 3]
    N = rays.shape[1]

    # --- ground plane ---
    dz = rays[..., 2]
    t_ground = torch.where(dz < -1e-4, o[:, 2:3] / torch.clamp(-dz, min=1e-6), INF)
    t_ground = torch.where(t_ground < spec.far, t_ground, INF)
    gxy = o_xy[:, None, :] + rays[..., :2] * t_ground[..., None]
    road, marking, sidewalk = _ground_masks(net, ego_pos, gxy)
    road_c = wx.wet_darken(widx, _color(_ASPHALT, dev))  # [E, 3]
    g = _color(_GRASS, dev) * (1 - sidewalk[..., None]) + _color(_SIDEWALK, dev) * sidewalk[..., None]
    g = g * (1 - road[..., None]) + road_c[:, None, :] * road[..., None]
    # World-anchored surface grain: two-scale value noise on the ground hit
    # point, stretched along motion.
    speed = world.ego_speed.abs()
    sxy = _motion_stretch(gxy, ego_yaw, speed)
    tex = grain_texture(sxy)  # 0.6 * _hash2(sxy, 1.7) + 0.4 * _hash2(sxy, 0.45) - 0.5
    amp_v = torch.rsqrt(1.0 + 0.11 * speed)[:, None]
    amp = (0.035 * road + 0.05 * (1.0 - road)) * amp_v
    g = torch.clamp(g + (amp * tex)[..., None], 0.0, 1.0)
    ground_color = g * (1 - marking[..., None]) + _color(_MARKING, dev) * marking[..., None]
    if _CROSSWALKS:
        jm = (_junction_markings(net, ego_pos, gxy) * road)[..., None]
        ground_color = ground_color * (1 - jm) + _color(_MARKING, dev) * jm

    # --- vehicles (all but the ego, unless a chase view includes it) and the
    # K nearest buildings: one merged slab pass over vertical boxes, in
    # camera-centered coordinates ---
    lo = 0 if include_ego else 1
    V1 = world.num_vehicles - lo
    Bg = net.bldg_xy.shape[0]
    KB = min(NUM_NEAR_BUILDINGS, Bg)
    veh_pal = const(tuple(_VEH_COLORS[(i + 1) % len(_VEH_COLORS)] for i in range(V1)),
                    torch.float32, dev)
    box_xy = [world.veh_pos[:, lo:] - o_xy[:, None]]
    box_yaw = [world.veh_yaw[:, lo:]]
    box_hl = [torch.full((E, V1), 4.7 / 2, dtype=torch.float32, device=dev)]
    box_hw = [torch.full((E, V1), 2.0 / 2, dtype=torch.float32, device=dev)]
    box_h = [torch.full((E, V1), VEH_HEIGHT, dtype=torch.float32, device=dev)]
    box_alive = [world.veh_alive[:, lo:]]
    box_pal = [veh_pal.reshape(1, V1, 3).expand(E, V1, 3)]
    # Taillight glow a vehicle (the switches; zero by default): brake lamps
    # when braking hard, dim constant lamps at night.
    lamps = _LAMPS or _NIGHT_LAMPS
    if lamps:
        vbrake = torch.clamp(world.veh_control[:, lo:, 2], 0.0, 1.0)
        vbrake = vbrake * (1.0 - world.veh_reverse[:, lo:].to(torch.float32))
        veh_glow = torch.zeros((E, V1), device=dev)
        if _LAMPS:
            veh_glow = torch.maximum(veh_glow, torch.where(vbrake > 0.45, 0.4 + 0.5 * vbrake, 0.0))
        if _NIGHT_LAMPS:
            veh_glow = torch.maximum(veh_glow, 0.55 * wx.night_level(widx)[:, None])
        box_glow = [veh_glow]
    if Bg > 0:
        d2b = torch.sum((net.bldg_xy - ego_pos[:, None]) ** 2, dim=-1)  # [E, Bg]
        nearb = nearest_k(d2b, KB)  # [E, KB]
        box_xy.append(net.bldg_xy[nearb] - o_xy[:, None])
        box_yaw.append(net.bldg_yaw[nearb])
        box_hl.append(net.bldg_half[nearb, 0])
        box_hw.append(net.bldg_half[nearb, 1])
        box_h.append(net.bldg_h[nearb])
        box_alive.append(torch.ones((E, KB), dtype=torch.bool, device=dev))
        box_pal.append(const(_BLDG_COLORS, torch.float32, dev)[nearb % len(_BLDG_COLORS)])
        if lamps:
            box_glow.append(torch.zeros((E, KB), device=dev))
    glow_pix = 0.0  # the vehicle layer's emissive strength
    if V1 + KB > 0:
        t_box, shade, *lamp = _ray_obb(oz, rays, torch.cat(box_xy, 1), torch.cat(box_yaw, 1),
                                       torch.cat(box_hl, 1), torch.cat(box_hw, 1),
                                       torch.cat(box_h, 1), lamps)
        t_box = torch.where(torch.cat(box_alive, 1)[:, None, :], t_box, INF)
        # The solve is materialised once in bf16 (the JAX function's
        # optimization barrier): t only picks the winning surface, and the
        # exact-min tie compare needs no epsilon because both sides are the
        # same bf16 values.
        t16, sh16 = t_box.to(torch.bfloat16), shade.to(torch.bfloat16)
        t_v16 = torch.amin(t16, dim=-1)
        # Restore exact INF for all-miss pixels, or the sky loses the depth
        # compare to the boxes.
        t_v = torch.where(t_v16 < _BF_INF, t_v16.to(torch.float32), INF)
        is_min = (t16 <= t_v16[..., None]) & (t16 < _BF_INF)
        count = torch.clamp(is_min.sum(dim=-1, keepdim=True, dtype=torch.int32), min=1)
        w_v = is_min.to(torch.float32) / count  # [E, N, B]
        sh_v = torch.sum(w_v * sh16.to(torch.float32), dim=-1)
        v_color = torch.bmm(w_v, torch.cat(box_pal, 1)) * sh_v[..., None]
        if lamps:  # blend the winning pixel toward the emissive lamp color
            gl16 = (lamp[0] * torch.cat(box_glow, 1)[:, None, :]).to(torch.bfloat16)
            glow_pix = torch.clamp(torch.sum(w_v * gl16.to(torch.float32), dim=-1), 0.0, 1.0)
            v_color = (v_color * (1.0 - glow_pix[..., None])
                       + _color(_TAILLIGHT, dev) * glow_pix[..., None])
    else:  # ego-only, building-free world
        t_v = torch.full((E, N), INF, device=dev)
        v_color = torch.zeros((E, N, 3), device=dev)

    # --- pedestrians ---
    t_ped_all = _ray_cylinder(oz, rays, world.ped_pos - o_xy[:, None], PED_RADIUS, PED_HEIGHT)
    t_ped_all = torch.where(world.ped_alive[:, None, :], t_ped_all, INF)
    t_p = torch.amin(t_ped_all, dim=-1)

    # --- traffic lights: pole + emissive head, K nearest to the ego ---
    L = net.num_lights
    K = min(NUM_NEAR_LIGHTS, max(L, 1))
    if L > 0:
        d2l = torch.sum((net.light_xy - ego_pos[:, None]) ** 2, dim=-1)
        near = nearest_k(d2l, K)  # [E, K]
        lxy = net.light_xy[near]
        lyaw = net.light_yaw[near]
        lstate = take(light_state, near)
        # Pole on the right-hand side of the stop line.
        right = torch.stack([torch.sin(lyaw), -torch.cos(lyaw)], dim=-1)
        pole_rel = lxy + right * 2.4 - o_xy[:, None]
        t_pole_min = torch.amin(_ray_cylinder(oz, rays, pole_rel, 0.12, LIGHT_POLE_H), dim=-1)
        head = torch.cat([pole_rel, torch.full((E, K, 1), LIGHT_POLE_H, device=dev)], dim=-1)
        t_head = _ray_sphere(oz, rays, head, LIGHT_HEAD_R)
        t_h = torch.amin(t_head, dim=-1)
        is_min_h = (t_head <= t_h[..., None] + 1e-3) & (t_head < INF)
        count_h = torch.clamp(is_min_h.sum(dim=-1, keepdim=True, dtype=torch.int32), min=1)
        head_palette = const(_LIGHT_COLORS, torch.float32, dev)[lstate]  # [E, K, 3]
        head_color = torch.bmm(is_min_h.to(torch.float32) / count_h, head_palette)
    else:
        t_pole_min = torch.full((E, N), INF, device=dev)
        t_h = torch.full((E, N), INF, device=dev)
        head_color = torch.zeros((E, N, 3), device=dev)

    # --- compose: nearest hit wins ---
    # Emissive strength: 1.0 for traffic-light heads, the glow for taillight
    # pixels (0 unless a lamp switch is on).
    t_hit = t_ground
    surf = ground_color
    emissive = torch.zeros((E, N), device=dev)
    for t_layer, c_layer, em in (
        (t_v, v_color, glow_pix),
        (t_p, _color(_PED_COLOR, dev), 0.0),
        (t_pole_min, _color(_POLE, dev), 0.0),
        (t_h, head_color, 1.0),
    ):
        closer = t_layer < t_hit
        surf = torch.where(closer[..., None], c_layer, surf)
        emissive = torch.where(closer, em, emissive)
        t_hit = torch.minimum(t_layer, t_hit)
    is_sky = t_hit >= INF

    # --- sky + atmosphere ---
    elev = torch.clamp(rays[..., 2] / 0.6, 0.0, 1.0)
    sky = wx.sky_color(widx, elev)
    lit = wx.apply_atmosphere(widx, surf, torch.clamp(t_hit, max=spec.far))
    # Emissive surfaces skip lighting/fog dimming proportionally.
    w_e = 0.9 * torch.where(is_sky, 0.0, emissive)[..., None]
    lit = surf * w_e + lit * (1.0 - w_e)
    color = torch.where(is_sky[..., None], sky, lit)

    img = color.reshape(E, H, W, 3)

    # --- screen-space weather: rain streaks, night headlight ---
    uu, vv = pixel_coords(spec, dev)
    dist_img = torch.clamp(t_hit, max=spec.far).reshape(E, H, W)
    img = wx.headlight(widx, uu, vv, dist_img, img)
    img = wx.rain_streaks(widx, uu, vv, world.time_s, img)
    img = motion_blur(img, speed * 3.6)
    return torch.clamp(img, 0.0, 1.0)
