"""2-D geometry helpers shared by dynamics, perception, rendering and routing
(port of ``cilrs_tpu/core/geometry.py``).

Conventions: world frame x-east / y-north, yaw in radians CCW from +x, all
distances in meters, speeds in m/s internally (km/h only at interfaces).
Every function broadcasts over leading dimensions, so the same code serves one
env or a batch of them.
"""

from __future__ import annotations

import functools

import torch

KMH_TO_MS = 1.0 / 3.6
MS_TO_KMH = 3.6


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once a device: ``torch.tensor(list,
    device=cuda)`` in per-tick code is a synchronous host-to-device copy,
    which would drain the launch queue every tick. Read-only."""
    return torch.tensor(values, dtype=dtype, device=device)


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def heading_vec(yaw: torch.Tensor) -> torch.Tensor:
    """Unit heading vector(s) [..., 2] for yaw [...]."""
    return torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)


def rot2d(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 2, 2] mapping body -> world."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def world_to_body(points: torch.Tensor, pos: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Transform world points [..., 2] into the body frame at (pos, yaw).

    Body frame: +x forward, +y left.
    """
    d = points - pos
    c, s = torch.cos(yaw), torch.sin(yaw)
    fx = d[..., 0] * c + d[..., 1] * s
    fy = -d[..., 0] * s + d[..., 1] * c
    return torch.stack([fx, fy], dim=-1)


def body_to_world(points: torch.Tensor, pos: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    wx = points[..., 0] * c - points[..., 1] * s
    wy = points[..., 0] * s + points[..., 1] * c
    return torch.stack([wx, wy], dim=-1) + pos


def cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar 2-D cross product a.x*b.y - a.y*b.x."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def norm2(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1) + eps)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` computes it:
    the square root of the sum of squares (``torch.linalg.norm`` may scale)."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def segment_distance(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance from point(s) p [..., 2] to segment(s) (a, b) [..., 2]."""
    ab = b - a
    t = torch.sum((p - a) * ab, dim=-1) / (torch.sum(ab * ab, dim=-1) + 1e-9)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return norm2(p - proj)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-env gather: x [E, N, ...] at idx [E, ...] -> [E, ..., *x.shape[2:]].

    The batched form of ``x[idx]`` for one env. Indices must be in range (the
    callers clamp, as the JAX code does: a bad index on the card is a device
    assert, where XLA would clamp it silently)."""
    E = x.shape[0]
    flat = idx.reshape(E, -1)
    trail = x.shape[2:]
    g = flat.reshape(E, -1, *([1] * len(trail))).expand(E, flat.shape[1], *trail)
    return torch.gather(x, 1, g).reshape(*idx.shape, *trail)
