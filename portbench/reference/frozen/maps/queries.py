"""Map queries: nearest waypoint, on-road test, texture sampling (port of
``cilrs_tpu/maps/queries.py``).

Dense argmin/gather over the flat waypoint arrays, for points [..., 2] of any
leading shape (one per env in the simulator). ``torch.argmin`` returns the
first minimum, as ``jnp.argmin`` does. JAX's ``lane_half_width()`` is
``maps.network.LANE_WIDTH / 2`` here.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.maps.network import RoadNetwork

OFF_ROAD_DIST = 3.5  # reference model/autonomous_drive.py:663


def _nearest(d2: torch.Tensor):
    idx = torch.argmin(d2, dim=-1)
    dist = torch.sqrt(torch.gather(d2, -1, idx[..., None]))[..., 0]
    return idx, dist


def nearest_waypoint(net: RoadNetwork, xy: torch.Tensor):
    """Nearest waypoint index (int64) + distance for point(s) xy [..., 2]."""
    d2 = torch.sum((xy[..., None, :] - net.wp_xy) ** 2, dim=-1)  # [..., W]
    return _nearest(d2)


def nearest_lane_waypoint(net: RoadNetwork, xy: torch.Tensor):
    """Nearest NON-junction waypoint (the reference projects to Driving lanes)."""
    d2 = torch.sum((xy[..., None, :] - net.wp_xy) ** 2, dim=-1)
    d2 = torch.where(net.wp_is_junction, torch.inf, d2)
    return _nearest(d2)


def is_on_road(net: RoadNetwork, xy: torch.Tensor) -> torch.Tensor:
    """True if within OFF_ROAD_DIST of a lane centerline (any waypoint)."""
    _, dist = nearest_waypoint(net, xy)
    return dist <= OFF_ROAD_DIST


def sample_texture(net: RoadNetwork, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the ground-texture masks at world xy [..., 2].

    Returns [..., 3] float32 in [0, 1]: (road, marking, sidewalk).
    """
    uv = (xy - net.tex_origin) / net.tex_scale  # texel coords (x, y)
    x = uv[..., 0]
    y = uv[..., 1]
    TH, TW = net.texture.shape[0], net.texture.shape[1]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, TW - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, TH - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    t = net.texture.to(torch.float32) / 255.0
    t00 = t[y0, x0]
    t01 = t[y0, x0 + 1]
    t10 = t[y0 + 1, x0]
    t11 = t[y0 + 1, x0 + 1]
    return (t00 * (1 - fx) * (1 - fy) + t01 * fx * (1 - fy)
            + t10 * (1 - fx) * fy + t11 * fx * fy)
