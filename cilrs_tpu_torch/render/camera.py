"""Pinhole camera model matching the reference's sensor rig (port of
``cilrs_tpu/render/camera.py``).

RGB camera at body offset (x=+2.0 forward, y=0, z=+1.4 up), FOV 100 degrees,
rendered at the network's 200x88 directly.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    width: int = 200
    height: int = 88
    fov_deg: float = 100.0
    offset_fwd: float = 2.0
    offset_up: float = 1.4
    pitch_deg: float = 0.0  # negative looks down
    far: float = 150.0

    @property
    def tan_half_fov(self) -> float:
        return math.tan(math.radians(self.fov_deg) / 2.0)


# Third-person spectator rig for the drive CLI's chase view: behind and above
# the ego, pitched down (the reference's chase-cam placement).
CHASE_CAMERA = CameraSpec(
    width=320, height=180, fov_deg=90.0,
    offset_fwd=-7.5, offset_up=3.2, pitch_deg=-12.0,
)


def pixel_coords(spec: CameraSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-centre coordinates (u, v) in [0, 1], each [H, W] (meshgrid 'xy')."""
    u = (torch.arange(spec.width, dtype=torch.float32, device=device) + 0.5) / spec.width
    v = (torch.arange(spec.height, dtype=torch.float32, device=device) + 0.5) / spec.height
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return uu, vv


def ray_directions(spec: CameraSpec, yaw: torch.Tensor) -> torch.Tensor:
    """World-frame unit ray directions [..., H, W, 3] for cameras with heading
    yaw [...].

    Axes: x,y world ground plane, z up. The camera looks along the vehicle
    heading; square pixels (vertical extent from the original 4:3 frame).
    """
    H, W = spec.height, spec.width
    th = spec.tan_half_fov
    dev = yaw.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2.0 - 1.0  # [-1, 1]
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2.0 - 1.0
    tv = th * 0.75
    vv, uu = torch.meshgrid(v * tv, u * th, indexing="ij")  # [H, W]

    pitch = math.radians(spec.pitch_deg)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    fwd = torch.stack([cy * cp, sy * cp, torch.full_like(yaw, sp)], dim=-1)
    right = torch.stack([sy, -cy, torch.zeros_like(yaw)], dim=-1)
    up = torch.stack([-cy * sp, -sy * sp, torch.full_like(yaw, cp)], dim=-1)

    lead = (...,) + (None, None)
    d = fwd[lead + (slice(None),)] + uu[..., None] * right[lead + (slice(None),)] \
        - vv[..., None] * up[lead + (slice(None),)]
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))


def camera_position(spec: CameraSpec, ego_pos: torch.Tensor, ego_yaw: torch.Tensor) -> torch.Tensor:
    """World position [..., 3] of the camera for ego at (pos [..., 2], yaw [...])."""
    fwd = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], dim=-1)
    xy = ego_pos + fwd * spec.offset_fwd
    z = torch.zeros_like(ego_yaw)[..., None] + spec.offset_up
    return torch.cat([xy, z], dim=-1)
