"""Route planning (host-side graph search) and route following over the fleet
(port of ``cilrs_tpu/maps/routing.py``).

Host side: Dijkstra over the directed waypoint graph (the native engine of
``native/roadgraph.cpp`` when it builds, else the same search in Python),
emitting fixed-length routes as numpy arrays named as the ``Route`` fields
(``core.convert.pool_from_arrays`` stacks the envs' pools onto the device;
JAX's ``stack_routes`` is the ``np.stack`` of a pool's routes in
``chained_route_pool``). The host code is the JAX package's numpy, so one seed traces the same routes
in both packages.

Device side, batched over envs (a route pool per env, ``[E, K, R, ...]``):
 - localization with the -5/+50 search window;
 - command lookahead: the current waypoint, then offsets [3, 5, 8, 12], first
   non-FOLLOW wins;
 - steer hint = normalized 2-D cross product vs. waypoint@+5, clipped;
 - route complete when < 10 m from the final waypoint.
Every index into a route is clamped to its length, as the JAX code clamps:
an index past the end would be a device assert on the card.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from cilrs_tpu_torch.core.geometry import const, take
from cilrs_tpu_torch.core.state import TensorTree
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.utils.profiling import span

ROUTE_MAX = 1024  # waypoints (~2 km at 2 m spacing)
CMD_FOLLOW, CMD_LEFT, CMD_RIGHT, CMD_STRAIGHT = 0, 1, 2, 3
LOCALIZE_BACK, LOCALIZE_FWD = 5, 50
LOOKAHEAD_OFFSETS = (3, 5, 8, 12)
HINT_OFFSET = 5
COMPLETE_DIST = 10.0


@dataclasses.dataclass(frozen=True)
class Route(TensorTree):
    """Each env's active route ([E, R, ...] fields, from ``RoutePool.get``),
    of length ROUTE_MAX, padded with the last waypoint."""

    xy: torch.Tensor  # [..., R, 2] f32
    yaw: torch.Tensor  # [..., R] f32
    option: torch.Tensor  # [..., R] i64 — TURN_*/CMD_* class of each waypoint
    wp_index: torch.Tensor  # [..., R] i64 — original network waypoint ids
    valid: torch.Tensor  # [..., R] bool
    length: torch.Tensor  # [...] i64 — number of valid entries
    kappa: torch.Tensor  # [..., R] f32 — signed curvature of the interval [i, i+1]


@dataclasses.dataclass(frozen=True)
class RoutePool(TensorTree):
    """The fleet's pools [E, K, R, ...]: K stacked routes an env, each env
    picks one by integer id."""

    xy: torch.Tensor  # [..., K, R, 2]
    yaw: torch.Tensor  # [..., K, R]
    option: torch.Tensor  # [..., K, R]
    wp_index: torch.Tensor  # [..., K, R]
    valid: torch.Tensor  # [..., K, R]
    length: torch.Tensor  # [..., K]
    kappa: torch.Tensor  # [..., K, R]

    @property
    def num_routes(self) -> int:
        return self.length.shape[-1]

    def get(self, route_id: torch.Tensor) -> Route:
        """Each env's active route from the fleet's pools: route_id [E]."""
        return Route(**{f.name: take(getattr(self, f.name), route_id)
                        for f in dataclasses.fields(self)})


# ---------------------------------------------------------------------------
# Host-side tracing
# ---------------------------------------------------------------------------


class _HostGraph:
    """Numpy views of a network's graph arrays for host-side search."""

    def __init__(self, net: RoadNetwork):
        h = net.host
        self.xy = h.wp_xy
        self.yaw = h.wp_yaw
        self.next = h.wp_next
        self.num_next = h.wp_num_next
        self.turn = h.wp_turn
        self.W = self.xy.shape[0]
        try:
            from cilrs_tpu_torch.maps.native_graph import NativeGraph

            self._nat_graph = NativeGraph(self.xy, self.next, self.num_next)
        except (OSError, RuntimeError):
            self._nat_graph = None  # no C++ compiler here: the Python search below

    def dijkstra(self, src: int, dst: int) -> list[int]:
        if self._nat_graph is not None:
            return list(self._nat_graph.shortest_path(int(src), int(dst)))
        dist = np.full(self.W, np.inf)
        prev = np.full(self.W, -1, np.int64)
        dist[src] = 0.0
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if u == dst:
                break
            if d > dist[u]:
                continue
            for k in range(self.num_next[u]):
                v = int(self.next[u, k])
                if v == u:
                    continue
                nd = d + float(np.linalg.norm(self.xy[v] - self.xy[u]))
                if nd < dist[v]:
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        if not np.isfinite(dist[dst]):
            return []
        path = [dst]
        while path[-1] != src:
            p = int(prev[path[-1]])
            if p < 0:
                return []
            path.append(p)
        return path[::-1]


def host_graph(net: RoadNetwork) -> _HostGraph:
    """The network's search graph, built once and kept on its host cache."""
    g = getattr(net.host, "graph", None)
    if g is None:
        g = net.host.graph = _HostGraph(net)
    return g


KAPPA_DEADBAND = 0.02  # 1/m: below this (r > 50 m) the label is EXACTLY zero


def _path_kappa(xy: np.ndarray, yaw: np.ndarray, n: int) -> np.ndarray:
    """Signed curvature of each route interval [i, i+1], from the traced
    polyline. With circular-fillet junction connectors (maps.network._fillet)
    this is piecewise CONSTANT — zero on straights (deadbanded exactly), 1/r on
    corner arcs — which is what makes the teacher's feedforward steer a flat,
    clonable plateau (agent/autopilot.py)."""
    k = np.zeros(len(xy), np.float32)
    if n >= 3:
        # Chord headings from POSITIONS (stored per-waypoint yaws repeat the
        # last segment heading inside each polyline, which punches a spurious
        # zero into every corner plateau).
        seg = xy[1:n] - xy[: n - 1]
        ds = np.linalg.norm(seg, axis=-1)
        cy = np.arctan2(seg[:, 1], seg[:, 0])  # [n-1]
        dpsi = cy[1:] - cy[:-1]  # turn angle at interior vertex i+1
        dpsi = (dpsi + np.pi) % (2 * np.pi) - np.pi
        kk = dpsi / np.maximum(0.5 * (ds[:-1] + ds[1:]), 0.5)
        kk[np.abs(kk) < KAPPA_DEADBAND] = 0.0
        # NO smoothing/snapping: the feedforward must integrate the polyline's
        # TRUE curvature profile (half-value chord vertices at the tangent
        # points included) or the teacher systematically cuts corners and the
        # correction term un-flattens the plateau. The entry/exit ramp is kept
        # SHORT by sampling fillet arcs at ~1 m (maps.network._fillet).
        # kk[j] is the curvature AT VERTEX j+1; store it there — an off-by-one
        # here makes the feedforward lead the road by a waypoint and cut every
        # corner. The teacher's linear interp then reproduces the profile
        # exactly at every fractional position.
        k[1 : n - 1] = np.clip(kk, -0.5, 0.5)
    return k


def _route_from_path(g: "_HostGraph", path: list[int]) -> dict:
    """One route's arrays, named as the ``Route`` fields."""
    n = len(path)
    idx = np.asarray(path, np.int32)
    pad = np.full(ROUTE_MAX - n, idx[-1], np.int32)
    idx_full = np.concatenate([idx, pad])
    valid = np.zeros(ROUTE_MAX, bool)
    valid[:n] = True
    xy = g.xy[idx_full].astype(np.float32)
    yaw = g.yaw[idx_full].astype(np.float32)
    return {
        "xy": xy,
        "yaw": yaw,
        "option": g.turn[idx_full].astype(np.int32),
        "wp_index": idx_full,
        "valid": valid,
        "length": np.int32(n),
        "kappa": _path_kappa(xy, yaw, n),
    }


def trace_route(net: RoadNetwork, start_wp: int, end_wp: int) -> dict | None:
    """Trace a route between two waypoint indices (host arrays); None if
    unreachable."""
    g = host_graph(net)
    path = g.dijkstra(int(start_wp), int(end_wp))
    if not path or len(path) < 4:
        return None
    return _route_from_path(g, path[:ROUTE_MAX])


def random_route(
    net: RoadNetwork,
    rng: np.random.RandomState,
    min_dist: float = 80.0,
    max_dist: float = 300.0,
    samples: int = 30,
) -> tuple[dict, int, int] | None:
    """Reference plan_route semantics: best random destination 80-300 m away
    (model/autonomous_drive.py:1469-1485), 30 candidate samples."""
    g = host_graph(net)
    spawns = net.host.spawn_wp
    start = int(spawns[rng.randint(len(spawns))])
    best = None
    p0 = g.xy[start]
    for _ in range(samples):
        cand = int(spawns[rng.randint(len(spawns))])
        d = float(np.linalg.norm(g.xy[cand] - p0))
        if min_dist <= d <= max_dist:
            r = trace_route(net, start, cand)
            if r is not None:
                return r, start, cand
        if best is None or abs(d - 150.0) < best[0]:
            best = (abs(d - 150.0), cand)
    if best is not None:
        r = trace_route(net, start, int(best[1]))
        if r is not None:
            return r, start, int(best[1])
    return None


@span("route_search")
def chained_route_pool(
    net: RoadNetwork,
    rng: np.random.RandomState,
    num_routes: int,
    start_wp: int | None = None,
    min_dist: float = 80.0,
    max_dist: float = 300.0,
    samples: int = 30,
    with_meta: bool = False,
):
    """Pre-trace `num_routes` routes, each starting where the previous ended,
    so on-device "replanning" (route completion, reference :1595-1600) is just
    `route_id + 1`. The chain wraps: the last route ends near the first's start
    when possible, otherwise the pool simply cycles with a teleport-sized jump.
    Returns the pool as host arrays [K, R, ...] named as the ``RoutePool``
    fields.
    """
    g = host_graph(net)
    spawns = net.host.spawn_wp
    if start_wp is None:
        start_wp = int(spawns[rng.randint(len(spawns))])
    # All candidate vetting happens on host paths (no device reads in the loop).
    paths: list[list[int]] = []
    starts: list[int] = []
    cur = start_wp
    attempts = 0
    while len(paths) < num_routes and attempts < num_routes * 20:
        attempts += 1
        cand = int(spawns[rng.randint(len(spawns))])
        d = float(np.linalg.norm(g.xy[cand] - g.xy[cur]))
        if not (min_dist <= d <= max_dist):
            continue
        path = g.dijkstra(cur, cand)
        if len(path) < 15:
            continue
        paths.append(path[:ROUTE_MAX])
        starts.append(cur)
        cur = cand
    if not paths:
        raise ValueError("could not trace any route on this network")
    if len(paths) < num_routes:
        # Close the cycle (cur -> start_wp) so cycling the pool keeps route
        # N+1 starting where route N ended; a failed back-trace leaves one
        # teleport-sized jump per cycle, as documented above.
        if cur != start_wp:
            back = g.dijkstra(cur, start_wp)
            if len(back) >= 2:
                paths.append(back[:ROUTE_MAX])
                starts.append(cur)
                cur = start_wp
        m = len(paths)
        while len(paths) < num_routes:
            k = len(paths) % m
            paths.append(paths[k])
            starts.append(starts[k])
    paths, starts = paths[:num_routes], starts[:num_routes]
    routes = [_route_from_path(g, p) for p in paths]
    pool = {k: np.stack([r[k] for r in routes]) for k in routes[0]}
    if with_meta:
        return pool, {"start_wps": starts, "lengths": [len(p) for p in paths]}
    return pool


# ---------------------------------------------------------------------------
# Device-side route following, batched over envs
# ---------------------------------------------------------------------------


def localize(route: Route, cur_idx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Closest route index within the [-5, +50) window around cur_idx [E]."""
    offsets = torch.arange(-LOCALIZE_BACK, LOCALIZE_FWD, device=cur_idx.device)
    cand = torch.minimum(torch.clamp(cur_idx[:, None] + offsets, min=0),
                         route.length[:, None] - 1)
    pts = take(route.xy, cand)  # [E, 55, 2]
    d2 = torch.sum((pts - pos[:, None]) ** 2, dim=-1)
    return torch.gather(cand, 1, torch.argmin(d2, dim=1, keepdim=True))[:, 0]


def get_command(route: Route, cur_idx: torch.Tensor) -> torch.Tensor:
    """High-level command: current waypoint's class, then lookahead offsets.

    Offset 0 comes first so a turn command HOLDS through the whole arc
    (cilrs_tpu/maps/routing.py:get_command gives the measurement).
    """
    last = route.length - 1
    offs = const((0,) + LOOKAHEAD_OFFSETS, torch.int64, cur_idx.device)
    opts = take(route.option, torch.minimum(cur_idx[:, None] + offs, last[:, None]))  # [E, 5]
    nonzero = opts != CMD_FOLLOW
    any_turn = nonzero.any(dim=1)
    first = torch.gather(opts, 1, torch.argmax(nonzero.to(torch.int32), dim=1, keepdim=True))[:, 0]
    fallback = take(route.option, torch.minimum(cur_idx + 8, last))
    return torch.where(any_turn, first, fallback)


def steer_hint(route: Route, cur_idx: torch.Tensor, pos: torch.Tensor,
               yaw: torch.Tensor) -> torch.Tensor:
    """Normalized cross-product steer hint toward waypoint@+HINT_OFFSET."""
    last = route.length - 1
    target = take(route.xy, torch.minimum(cur_idx + HINT_OFFSET, last))
    d = target - pos
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    cross = torch.cos(yaw) * d[:, 1] - torch.sin(yaw) * d[:, 0]
    hint = cross / torch.clamp(dist, min=1.0)
    hint = torch.where(dist < 0.1, 0.0, hint)
    return torch.clamp(hint, -1.0, 1.0)


def distance_remaining(route: Route, pos: torch.Tensor) -> torch.Tensor:
    end = take(route.xy, route.length - 1)
    return torch.sqrt(torch.sum((end - pos) ** 2, dim=-1) + 1e-12)


def is_complete(route: Route, pos: torch.Tensor, threshold: float = COMPLETE_DIST) -> torch.Tensor:
    return distance_remaining(route, pos) < threshold
