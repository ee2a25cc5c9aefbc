"""Landmark -> spawn-point mapping (port of ``cilrs_tpu/maps/landmarks.py``,
map_landmarks.py parity).

The reference hard-codes 20 campus landmark GPS coordinates, projects them
with the converter's equirectangular formula, snaps each to the nearest
spawn point, and prints suggested demo routes (map_landmarks.py:31-128).
Here the same works against any RoadNetwork and any landmark table, on the
network's host arrays.
"""

from __future__ import annotations

import numpy as np

from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.maps.osm import lat_lon_to_xy


def landmarks_to_spawns(
    net: RoadNetwork,
    landmarks: dict[str, tuple[float, float]],  # name -> (lat, lon)
    origin: tuple[float, float],  # (lat0, lon0) used when the map was built
) -> dict[str, dict]:
    """Returns name -> {spawn_index, waypoint, xy, snap_dist_m}."""
    spawn_wp = net.host.spawn_wp
    spawn_xy = net.host.wp_xy[spawn_wp]
    out = {}
    for name, (lat, lon) in landmarks.items():
        xy = np.asarray(lat_lon_to_xy(lat, lon, origin[0], origin[1]))
        d = np.linalg.norm(spawn_xy - xy, axis=1)
        k = int(np.argmin(d))
        out[name] = {"spawn_index": k, "waypoint": int(spawn_wp[k]), "xy": spawn_xy[k].tolist(),
                     "snap_dist_m": float(d[k])}
    return out


def suggest_routes(mapping: dict[str, dict], num: int = 6, min_sep_m: float = 100.0):
    """Suggested demo routes between distant landmark pairs
    (map_landmarks.py:111-128 prints --spawn/--destination pairs)."""
    names = list(mapping.keys())
    routes = []
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = float(np.linalg.norm(np.asarray(mapping[a]["xy"]) - np.asarray(mapping[b]["xy"])))
            if d >= min_sep_m:
                routes.append((d, a, b))
    routes.sort(reverse=True)
    return [{"from": a, "to": b, "distance_m": d,
             "cli": f"--spawn {mapping[a]['spawn_index']} --destination {mapping[b]['spawn_index']}"}
            for d, a, b in routes[:num]]
