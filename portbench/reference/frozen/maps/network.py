"""RoadNetwork: the map as tensors on a device, and the host-side graph builder
(port of ``cilrs_tpu/maps/network.py``).

The map is a directed lane-waypoint graph sampled at ~2 m, stored as flat
arrays so every query (nearest waypoint, on-road test, route localization) is
a dense gather/argmin over the fleet. The builder is numpy, copied from the JAX
package so that both build identical arrays from one graph; ``RoadNetwork``
holds them as tensors on one device, and ``host`` keeps the numpy arrays that
host code (routing, spawning) reads (JAX's ``host_arrays(net)``: here every
network carries them).

By default every light runs on one town-global clock. The JAX package's
switch ``CILRS_TPU_STAGGER_LIGHTS=1`` (unless ``CILRS_TPU_GLOBAL_LIGHTS=1``)
gives each junction its own phase offset, read when a network is built.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

LANE_WIDTH = 3.5
SIDEWALK_WIDTH = 2.0
WP_SPACING = 2.0
JUNCTION_SETBACK = 9.0
MAX_NEXT = 3

# Turn classes for junction connectors (match reference command encoding:
# 0=LANEFOLLOW, 1=LEFT, 2=RIGHT, 3=STRAIGHT).
TURN_FOLLOW, TURN_LEFT, TURN_RIGHT, TURN_STRAIGHT = 0, 1, 2, 3

# Traffic-light cycle (seconds): green then yellow per phase group, two groups.
# The 10 s green is load-bearing for training quality (cilrs_tpu/maps/network.py
# explains the measurement).
LIGHT_GREEN_S = 10.0
LIGHT_YELLOW_S = 3.0
LIGHT_PHASE_S = LIGHT_GREEN_S + LIGHT_YELLOW_S
LIGHT_CYCLE_S = 2.0 * LIGHT_PHASE_S
LIGHT_GREEN, LIGHT_YELLOW, LIGHT_RED, LIGHT_NONE = 0, 1, 2, 3

# Fields of RoadNetwork that host code reads, mirrored in numpy by ``host``.
HOST_FIELDS = ("wp_xy", "wp_yaw", "wp_next", "wp_num_next", "wp_prev", "wp_turn",
               "wp_is_junction", "wp_left", "wp_right", "spawn_wp", "light_xy",
               "light_yaw", "light_group", "light_wp", "light_offset")


class HostCache:
    """Numpy mirrors of map arrays for host-side code (routing, spawning, CLI),
    so host code never reads the device."""

    def __init__(self, **arrays):
        self.__dict__.update(arrays)


@dataclasses.dataclass(frozen=True)
class RoadNetwork:
    """Static map data as tensors on one device. W waypoints, L lights, S spawn
    points, Bg building lots."""

    wp_xy: torch.Tensor  # [W, 2] f32
    wp_yaw: torch.Tensor  # [W] f32
    wp_next: torch.Tensor  # [W, MAX_NEXT] i64, padded with own index
    wp_num_next: torch.Tensor  # [W] i64
    wp_prev: torch.Tensor  # [W] i64 — one predecessor (for teleport-back)
    wp_turn: torch.Tensor  # [W] i64 — TURN_* class (junction connectors)
    wp_is_junction: torch.Tensor  # [W] bool
    wp_left: torch.Tensor  # [W] i64 — adjacent same-direction lane wp, -1 if none
    wp_right: torch.Tensor  # [W] i64
    spawn_wp: torch.Tensor  # [S] i64 — spawn-point waypoint indices

    light_xy: torch.Tensor  # [L, 2] — stop-line position
    light_yaw: torch.Tensor  # [L] — heading of controlled traffic
    light_group: torch.Tensor  # [L] i64 — phase group (0 or 1)
    light_wp: torch.Tensor  # [L] i64 — waypoint at the stop line
    light_offset: torch.Tensor  # [L] f32 — per-junction cycle phase offset, s

    texture: torch.Tensor  # [TH, TW, 3] uint8 masks: road, marking, sidewalk
    tex_origin: torch.Tensor  # [2] world xy of texel (0, 0)
    tex_scale: torch.Tensor  # 0-d f32, meters per texel

    # Procedural buildings lining the roads; padded entries have height 0
    # and a far-away center.
    bldg_xy: torch.Tensor  # [Bg, 2] f32
    bldg_yaw: torch.Tensor  # [Bg] f32
    bldg_half: torch.Tensor  # [Bg, 2] f32 — (half_l, half_w)
    bldg_h: torch.Tensor  # [Bg] f32 — height, 0 for padding

    host: HostCache = dataclasses.field(default=None, compare=False)

    @property
    def num_waypoints(self) -> int:
        return self.wp_xy.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_xy.shape[0]

    @property
    def num_spawn_points(self) -> int:
        return self.spawn_wp.shape[0]

    @property
    def device(self) -> torch.device:
        return self.wp_xy.device

    def to(self, device) -> "RoadNetwork":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "host"})

    @classmethod
    def from_arrays(cls, arrays: dict, device="cpu") -> "RoadNetwork":
        """A network from numpy arrays named as the fields (integer arrays
        become int64 tensors, for indexing)."""
        def tensor(a):
            a = np.asarray(a)
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            return torch.tensor(a, device=device)

        host = HostCache(**{k: np.asarray(arrays[k]) for k in HOST_FIELDS})
        return cls(**{f.name: tensor(arrays[f.name]) for f in dataclasses.fields(cls)
                      if f.name != "host"}, host=host)


def light_states(net: RoadNetwork, time_s: torch.Tensor) -> torch.Tensor:
    """Traffic-light state per env and light at each env's sim time [E]:
    [E, L] int64, 0 green / 1 yellow / 2 red.

    Two phase groups alternate on a fixed cycle (group 0 = east-west
    approaches, group 1 = north-south). ``torch.remainder`` is floor-mod, as
    ``jnp.mod`` is (``torch.fmod`` is not)."""
    local = _light_local(net, time_s)
    return torch.where(local < LIGHT_GREEN_S, LIGHT_GREEN,
                       torch.where(local < LIGHT_PHASE_S, LIGHT_YELLOW, LIGHT_RED))


def light_state_ages(net: RoadNetwork, time_s: torch.Tensor) -> torch.Tensor:
    """Seconds since each light entered its current state ([E, L] f32)."""
    local = _light_local(net, time_s)
    return torch.where(local < LIGHT_GREEN_S, local,
                       torch.where(local < LIGHT_PHASE_S, local - LIGHT_GREEN_S,
                                   local - LIGHT_PHASE_S))


def _light_local(net: RoadNetwork, time_s: torch.Tensor) -> torch.Tensor:
    t = torch.remainder(time_s, LIGHT_CYCLE_S)[:, None]
    local = t - net.light_group.to(torch.float32) * LIGHT_PHASE_S - net.light_offset
    return torch.remainder(local, LIGHT_CYCLE_S)


# ---------------------------------------------------------------------------
# Host-side builder (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphSpec:
    """Plain node/edge road graph. Nodes [N,2]; edges as (i, j) index pairs."""

    nodes: np.ndarray
    edges: list
    lanes_per_dir: int = 1


def _bezier(p0, h0, p1, h1, n):
    """Cubic bezier from p0 with heading h0 to p1 with heading h1, n samples."""
    d = np.linalg.norm(p1 - p0)
    c0 = p0 + h0 * d * 0.4
    c1 = p1 - h1 * d * 0.4
    t = np.linspace(0.0, 1.0, n)[:, None]
    pts = ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * c0
           + 3 * (1 - t) * t ** 2 * c1 + t ** 3 * p1)
    return pts


def _fillet(p0, h0, p1, h1, spacing):
    """Line + circular-arc + line connector from p0/heading h0 to p1/heading h1.

    Junction corners are tangent circular fillets (how real intersections are
    built). The payoff over a bezier is CONSTANT curvature along the whole
    corner: the kinematically exact steer through it is a flat plateau with a
    one-waypoint ramp, so the autopilot's steer labels on turn frames become a
    (visually anchored) step function instead of a continuous ramp the 88x200
    camera cannot resolve — the reference's LEFT/RIGHT steer-MAE of ~0.004
    (evaluation_report.json:40-55) is only clonable from labels this flat.
    Falls back to a bezier when the heading lines don't intersect ahead.
    Returns a polyline INCLUDING both endpoints, ~`spacing` m apart.
    """
    chord = p1 - p0
    cross = h0[0] * h1[1] - h0[1] * h1[0]
    dot = float(np.clip(np.dot(h0, h1), -1.0, 1.0))
    theta = float(np.arctan2(abs(cross), dot))  # total heading change
    if theta < 0.06:  # straight-through connector
        n = max(4, int(round(np.linalg.norm(chord) / spacing)) + 1)
        return p0 + chord * np.linspace(0.0, 1.0, n)[:, None]
    # Corner point C: p0 + a*h0 == p1 - b*h1, both a,b > 0 required.
    A = np.stack([h0, -h1], axis=1)
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    if abs(det) < 1e-9:
        return _bezier(p0, h0, p1, h1,
                       max(4, int(round(np.linalg.norm(chord) / spacing)) + 1))
    ab = np.linalg.solve(A, chord)
    a, b = float(ab[0]), float(ab[1])
    if a <= 0.1 or b <= 0.1:
        return _bezier(p0, h0, p1, h1,
                       max(4, int(round(np.linalg.norm(chord) / spacing)) + 1))
    C = p0 + h0 * a
    tl = min(a, b)  # tangent length from C; radius r = tl / tan(theta/2)
    r = tl / max(np.tan(theta / 2.0), 1e-6)
    T0 = C - h0 * tl  # arc start (on the incoming line)
    T1 = C + h1 * tl  # arc end (on the outgoing line)
    side = 1.0 if cross > 0 else -1.0  # +1 left turn
    n0 = np.array([-h0[1], h0[0]]) * side  # unit normal toward the arc center
    O = T0 + n0 * r
    a0 = np.arctan2(T0[1] - O[1], T0[0] - O[0])
    sweep = side * theta
    # Arcs sample at HALF the lane spacing: the chord-heading curvature at the
    # two tangent-point vertices is half the arc value, so the teacher's steer
    # ramp spans one sample interval on each side — 1 m keeps it to ~4 frames.
    n_arc = max(4, int(round(abs(sweep) * r / (0.5 * spacing))) + 1)
    ang = a0 + np.linspace(0.0, sweep, n_arc)
    arc = O + r * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    pieces = []
    d_in = a - tl
    if d_in > 0.25:  # tangent point short of p0: straight lead-in
        n_in = max(2, int(round(d_in / spacing)) + 1)
        pieces.append(p0 + (T0 - p0) * np.linspace(0.0, 1.0, n_in)[:-1, None])
    pieces.append(arc)
    d_out = b - tl
    if d_out > 0.25:  # tangent point short of p1: straight lead-out
        n_out = max(2, int(round(d_out / spacing)) + 1)
        pieces.append(T1 + (p1 - T1) * np.linspace(0.0, 1.0, n_out)[1:, None])
    return np.concatenate(pieces, axis=0)


def _yaws_from_polyline(pts):
    d = np.diff(pts, axis=0)
    yaw = np.arctan2(d[:, 1], d[:, 0])
    return np.concatenate([yaw, yaw[-1:]])


def build_network(
    spec: GraphSpec,
    tex_scale: float = 0.5,
    spawn_spacing: float = 12.0,
    with_lights: bool = True,
) -> RoadNetwork:
    """Compile a node/edge graph into a RoadNetwork on the CPU (host-side,
    numpy); ``.to(device)`` moves it."""
    nodes = np.asarray(spec.nodes, np.float64)
    degree = np.zeros(len(nodes), np.int64)
    node_dirs: list[list[np.ndarray]] = [[] for _ in nodes]
    for i, j in spec.edges:
        degree[i] += 1
        degree[j] += 1
        d = nodes[j] - nodes[i]
        d = d / max(np.linalg.norm(d), 1e-9)
        node_dirs[i].append(d)
        node_dirs[j].append(-d)

    # Per-node connector setback. Degree-2 nodes where the road BENDS (grid
    # perimeter corners) get the full junction setback: with only 2 m the
    # corner fillet radius collapses to ~2.5 m, which saturates the steer at
    # 1.0 on frames labeled LANEFOLLOW — unlearnable labels AND un-drivable
    # geometry. With 9 m the bend becomes a wide ~9 m arc, like Town01's
    # curved perimeter roads (driven under LANEFOLLOW in the reference too).
    setback = np.full(len(nodes), 2.0)
    for nix in range(len(nodes)):
        if degree[nix] >= 3:
            setback[nix] = JUNCTION_SETBACK
        elif degree[nix] == 2:
            d0, d1 = node_dirs[nix]
            if abs(np.dot(d0, d1)) < 0.98:  # not collinear: a bend
                setback[nix] = JUNCTION_SETBACK

    wp_xy, wp_yaw, wp_turn, wp_junc = [], [], [], []
    wp_left, wp_right = [], []
    next_lists: list[list[int]] = []
    prev_of: list[int] = []

    # Per directed lane bookkeeping: (in_node, out_node, lane_k) -> (first_wp, last_wp)
    lane_entry: dict = {}
    lane_exit: dict = {}
    # For junction connectors: incoming lanes ending at node n / outgoing starting at n.
    incoming: dict[int, list] = {}
    outgoing: dict[int, list] = {}

    def add_polyline(pts, turn, junction, left_offset_partner=None):
        yaws = _yaws_from_polyline(pts)
        base = len(wp_xy)
        n = len(pts)
        for k in range(n):
            wp_xy.append(pts[k])
            wp_yaw.append(yaws[k])
            wp_turn.append(turn)
            wp_junc.append(junction)
            wp_left.append(-1)
            wp_right.append(-1)
            next_lists.append([base + k + 1] if k + 1 < n else [])
            prev_of.append(base + k - 1 if k > 0 else -1)
        return base, base + n - 1

    lane_offsets = [LANE_WIDTH * (0.5 + k) for k in range(spec.lanes_per_dir)]

    for eid, (i, j) in enumerate(spec.edges):
        for (a, b) in ((i, j), (j, i)):
            pa, pb = nodes[a], nodes[b]
            d = pb - pa
            length = np.linalg.norm(d)
            h = d / max(length, 1e-9)
            right = np.array([h[1], -h[0]])  # right-hand side of travel
            sa = setback[a]
            sb = setback[b]
            usable = length - sa - sb
            if usable < WP_SPACING * 2:
                continue
            n = max(2, int(round(usable / WP_SPACING)) + 1)
            t = np.linspace(sa, length - sb, n)[:, None]
            lane_ids = []
            for k, off in enumerate(lane_offsets):
                pts = pa + h * t + right * off
                first, last = add_polyline(pts, TURN_FOLLOW, False)
                lane_ids.append((first, last, n))
                incoming.setdefault(b, []).append((first, last, h.copy(), eid, k))
                outgoing.setdefault(a, []).append((first, last, h.copy(), eid, k))
            # Same-direction adjacency between lanes k and k+1 (for overtake).
            for k in range(len(lane_ids) - 1):
                f0, _, n0 = lane_ids[k]
                f1, _, _ = lane_ids[k + 1]
                for q in range(n0):
                    wp_right[f0 + q] = f1 + q  # lane k+1 is further right
                    wp_left[f1 + q] = f0 + q

    # Junction connectors.
    for nidx in range(len(nodes)):
        ins = incoming.get(nidx, [])
        outs = outgoing.get(nidx, [])
        for (fi, li, hi, ei, ki) in ins:
            end_pt = np.asarray(wp_xy[li])
            for (fo, lo, ho, eo, ko) in outs:
                if eo == ei:  # no U-turns back onto the same road
                    continue
                start_pt = np.asarray(wp_xy[fo])
                gap = np.linalg.norm(start_pt - end_pt)
                if gap > 2.5 * (JUNCTION_SETBACK * 2 + LANE_WIDTH * 4):
                    continue
                cross = hi[0] * ho[1] - hi[1] * ho[0]
                dot = float(np.dot(hi, ho))
                if dot > 0.7:
                    turn = TURN_STRAIGHT
                elif cross > 0:
                    turn = TURN_LEFT
                else:
                    turn = TURN_RIGHT
                pts = _fillet(end_pt, hi, start_pt, ho, WP_SPACING)[1:-1]
                if len(pts) < 1:
                    continue
                junction = degree[nidx] >= 3
                # Tight degree-2 bends (grid-perimeter corners) are plain
                # curved road — no navigation choice — but their fillets
                # demand sustained |steer| ~ 0.5, and leaving them CMD_FOLLOW
                # dumps hard-steer arcs into the model's LANEFOLLOW branch:
                # 13.6% of LANEFOLLOW frames were |steer| > 0.3, against a
                # reference FOLLOW branch that is essentially flat (steer MAE
                # 0.0041, with 41% of its val frames commanded LEFT/RIGHT, in
                # the reference's evaluation_report.json per_command_metrics).
                # Marking bends with their geometric turn class reproduces the
                # reference's command/label shape; geometry, routes, spawn
                # indices and scoring are untouched.
                bend_turn = (not junction) and dot <= 0.7
                first, last = add_polyline(
                    pts, turn if (junction or bend_turn) else TURN_FOLLOW,
                    bool(junction))
                next_lists[li].append(first)
                if prev_of[first] < 0:
                    prev_of[first] = li
                next_lists[last].append(fo)
                if prev_of[fo] < 0:
                    prev_of[fo] = last

    W = len(wp_xy)
    if W == 0:
        raise ValueError("graph produced no waypoints")
    xy = np.asarray(wp_xy, np.float32)
    yaw = np.asarray(wp_yaw, np.float32)
    turn = np.asarray(wp_turn, np.int32)
    junc = np.asarray(wp_junc, bool)
    left = np.asarray(wp_left, np.int32)
    right_arr = np.asarray(wp_right, np.int32)
    nxt = np.full((W, MAX_NEXT), -1, np.int32)
    num_next = np.zeros(W, np.int32)
    for w, lst in enumerate(next_lists):
        lst = lst[:MAX_NEXT]
        num_next[w] = len(lst)
        for k, v in enumerate(lst):
            nxt[w, k] = v
    # Pad successor slots with own index so gathers stay in-bounds.
    own = np.arange(W, dtype=np.int32)[:, None]
    nxt = np.where(nxt < 0, own, nxt)
    prev = np.asarray(prev_of, np.int32)
    prev = np.where(prev < 0, np.arange(W, dtype=np.int32), prev)

    # Spawn points: non-junction lane waypoints, spaced along each lane.
    stride = max(1, int(round(spawn_spacing / WP_SPACING)))
    spawn = [w for w in range(W) if not junc[w] and (w % stride == 0) and num_next[w] > 0]
    spawn_wp = np.asarray(spawn, np.int32)

    # Traffic lights: one per incoming lane at junction nodes (degree >= 3).
    # Every light at one junction shares a phase OFFSET unique to that
    # junction (golden-ratio stagger over the cycle): junction controllers
    # are mutually unsynchronized like CARLA's, killing the town-global
    # red-wave resonance (see light_states).
    lxy, lyaw, lgroup, lwp, loff = [], [], [], [], []
    if with_lights:
        # Default: one town-global clock, every offset 0 (the staggered
        # offsets are opt-in, as in the JAX package).
        stagger = (os.environ.get("CILRS_TPU_STAGGER_LIGHTS") == "1"
                   and os.environ.get("CILRS_TPU_GLOBAL_LIGHTS") != "1")
        n_junctions = 0
        for nidx in range(len(nodes)):
            if degree[nidx] < 3:
                continue
            j_offset = ((n_junctions * 0.618033988749895) % 1.0 * LIGHT_CYCLE_S
                        if stagger else 0.0)
            n_junctions += 1
            for (fi, li, hi, ei, ki) in incoming.get(nidx, []):
                lxy.append(wp_xy[li])
                lyaw.append(np.arctan2(hi[1], hi[0]))
                lgroup.append(0 if abs(hi[0]) >= abs(hi[1]) else 1)
                lwp.append(li)
                loff.append(j_offset)
    L = len(lxy)
    light_xy = np.asarray(lxy, np.float32).reshape(L, 2)
    light_yaw = np.asarray(lyaw, np.float32)
    light_group = np.asarray(lgroup, np.int32)
    light_wp = np.asarray(lwp, np.int32)
    light_offset = np.asarray(loff, np.float32)

    texture, origin = _rasterize_texture(xy, yaw, junc, tex_scale)
    bxy, byaw, bhalf, bh = _generate_buildings(xy, yaw, junc)

    return RoadNetwork.from_arrays(dict(
        wp_xy=xy, wp_yaw=yaw, wp_next=nxt, wp_num_next=num_next, wp_prev=prev,
        wp_turn=turn, wp_is_junction=junc, wp_left=left, wp_right=right_arr,
        spawn_wp=spawn_wp, light_xy=light_xy, light_yaw=light_yaw,
        light_group=light_group, light_wp=light_wp, light_offset=light_offset,
        texture=texture, tex_origin=origin.astype(np.float32),
        tex_scale=np.float32(tex_scale), bldg_xy=bxy, bldg_yaw=byaw, bldg_half=bhalf,
        bldg_h=bh))


def _generate_buildings(xy: np.ndarray, yaw: np.ndarray, junc: np.ndarray,
                        max_count: int = 320):
    """Deterministic building lots along both road sides (host, numpy).

    Candidates every ~7 waypoints, offset 10-16 m laterally, sized/heighted by
    a position hash; kept only if clear of every lane centerline and of other
    buildings. Padded to max_count with height-0 far-away entries."""

    def h01(a, b):
        return (np.sin(a * 12.9898 + b * 78.233) * 43758.5453) % 1.0

    keep_xy, keep_yaw, keep_half, keep_h = [], [], [], []
    for w in range(0, len(xy), 7):
        if junc[w]:
            continue
        hx, hy = np.cos(yaw[w]), np.sin(yaw[w])
        for side in (-1.0, 1.0):
            r = h01(xy[w, 0] * side, xy[w, 1])
            off = 10.0 + 6.0 * r
            cx = xy[w, 0] - hy * off * side
            cy = xy[w, 1] + hx * off * side
            half = np.array([3.0 + 4.0 * h01(cx, cy), 3.0 + 4.0 * h01(cy, cx)],
                            np.float32)
            # Clear of all lanes (center must be road-half + diag away)...
            d = np.min(np.hypot(xy[:, 0] - cx, xy[:, 1] - cy))
            if d < float(np.hypot(half[0], half[1])) + 5.5:
                continue
            # ...and of previously accepted buildings.
            ok = True
            for (px, py), ph in zip(keep_xy, keep_half):
                if np.hypot(px - cx, py - cy) < float(
                        np.hypot(*half) + np.hypot(*ph)) + 1.0:
                    ok = False
                    break
            if not ok:
                continue
            keep_xy.append((cx, cy))
            keep_yaw.append(yaw[w])
            keep_half.append(half)
            keep_h.append(4.0 + 6.0 * h01(cx + 1.0, cy - 1.0))
            if len(keep_xy) >= max_count:
                break
        if len(keep_xy) >= max_count:
            break
    n = len(keep_xy)
    pad = max_count - n
    bxy = np.concatenate([np.asarray(keep_xy, np.float32).reshape(n, 2),
                          np.full((pad, 2), 1e6, np.float32)])
    byaw = np.concatenate([np.asarray(keep_yaw, np.float32), np.zeros(pad, np.float32)])
    bhalf = np.concatenate([np.asarray(keep_half, np.float32).reshape(n, 2),
                            np.ones((pad, 2), np.float32)])
    bh = np.concatenate([np.asarray(keep_h, np.float32), np.zeros(pad, np.float32)])
    return bxy, byaw, bhalf, bh


def _rasterize_texture(xy: np.ndarray, yaw: np.ndarray, junc: np.ndarray, scale: float):
    """Rasterize road/marking/sidewalk masks on a regular grid (host, numpy).

    Marks every texel within LANE_WIDTH of a lane-center waypoint as road,
    within road+SIDEWALK as sidewalk, and paints dashed center markings along
    non-junction lane waypoints.
    """
    margin = 16.0
    lo = xy.min(axis=0) - margin
    hi = xy.max(axis=0) + margin
    shape = np.ceil((hi - lo) / scale).astype(np.int64)
    TH, TW = int(shape[1]), int(shape[0])
    # Rounded up to multiples of 8, as the JAX package lays it out.
    TH += (-TH) % 8
    TW += (-TW) % 8
    tex = np.zeros((TH, TW, 3), np.uint8)

    def stamp(mask_idx, pts, radius, value=255):
        r = int(np.ceil(radius / scale))
        ij = np.floor((pts - lo) / scale).astype(np.int64)
        yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
        disk = (yy * yy + xx * xx) * (scale * scale) <= radius * radius
        dy, dx = np.nonzero(disk)
        dy, dx = dy - r, dx - r
        rows = (ij[:, 1][:, None] + dy[None, :]).ravel()
        cols = (ij[:, 0][:, None] + dx[None, :]).ravel()
        ok = (rows >= 0) & (rows < TH) & (cols >= 0) & (cols < TW)
        tex[rows[ok], cols[ok], mask_idx] = value

    # Sidewalk band first (under road), then road, then markings.
    stamp(2, xy, LANE_WIDTH / 2 + LANE_WIDTH + SIDEWALK_WIDTH)
    stamp(0, xy, LANE_WIDTH / 2 + LANE_WIDTH * 0.75)
    # Dashed center-line markings: every other pair of waypoints, lane side edge.
    lane_pts = xy[~junc]
    lane_yaw = yaw[~junc]
    keep = (np.arange(len(lane_pts)) % 3) != 2  # 2-on / 1-off dash pattern
    right = np.stack([np.sin(lane_yaw), -np.cos(lane_yaw)], axis=-1)
    center_edge = lane_pts - right * (LANE_WIDTH / 2)  # road centerline side
    stamp(1, center_edge[keep], 0.3)

    return tex, lo.astype(np.float32)
