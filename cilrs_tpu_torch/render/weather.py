"""Procedural weather shading for the rasterizer (port of
``cilrs_tpu/render/weather.py``).

The five presets (clear / rain / fog / night / hardrain) as a per-weather
parameter table applied in the shader: sky colors, ambient light, fog density,
rain streaks, wet-road darkening and a night headlight cone. Each env selects
its row by its weather index, so one fleet can mix weathers. Every function
takes weather_idx [E] and per-env images [E, ...].
"""

from __future__ import annotations

import torch

from cilrs_tpu_torch.config import WEATHER_NAMES
from cilrs_tpu_torch.core.geometry import const

# Per-weather shader parameters, rows ordered like WEATHER_NAMES:
#   clear, rain, fog, night, hardrain
_SKY_TOP = (
    (0.45, 0.66, 0.95),
    (0.45, 0.50, 0.58),
    (0.70, 0.72, 0.74),
    (0.02, 0.03, 0.08),
    (0.30, 0.33, 0.38),
)
_SKY_HORIZON = (
    (0.78, 0.86, 0.98),
    (0.60, 0.64, 0.68),
    (0.80, 0.81, 0.82),
    (0.05, 0.06, 0.12),
    (0.42, 0.45, 0.50),
)
_AMBIENT = (1.0, 0.75, 0.85, 0.25, 0.55)
_FOG_DENSITY = (0.002, 0.010, 0.045, 0.012, 0.030)
_RAIN = (0.0, 0.5, 0.0, 0.0, 1.0)
_WET = (0.0, 0.6, 0.1, 0.0, 0.9)
_NIGHT = (0.0, 0.0, 0.0, 1.0, 0.0)

assert len(_SKY_TOP) == len(WEATHER_NAMES)


def _row(table: tuple, weather_idx: torch.Tensor) -> torch.Tensor:
    return const(table, torch.float32, weather_idx.device)[weather_idx]


def _per_env(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[E, ...] parameters broadcast against per-env images ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def night_level(weather_idx: torch.Tensor) -> torch.Tensor:
    """0..1 darkness factor [E] (1 for the night preset): taillight gating."""
    return _row(_NIGHT, weather_idx)


def sky_color(weather_idx: torch.Tensor, elev01: torch.Tensor) -> torch.Tensor:
    """Sky gradient; elev01 [E, ...] in [0,1], 0 = horizon. Returns [E, ..., 3]."""
    top = _row(_SKY_TOP, weather_idx)  # [E, 3]
    hor = _row(_SKY_HORIZON, weather_idx)
    t = torch.clamp(elev01, 0.0, 1.0)[..., None]
    lead = (slice(None),) + (None,) * (elev01.dim() - 1)
    return hor[lead] * (1.0 - t) + top[lead] * t


def fog_color(weather_idx: torch.Tensor) -> torch.Tensor:
    return _row(_SKY_HORIZON, weather_idx)


def apply_atmosphere(
    weather_idx: torch.Tensor,
    color: torch.Tensor,  # [E, ..., 3] surface color
    dist: torch.Tensor,  # [E, ...] distance to surface, m
) -> torch.Tensor:
    """Ambient light + exponential fog toward the horizon color."""
    amb = _per_env(_row(_AMBIENT, weather_idx), color)
    lit = color * amb
    f = 1.0 - torch.exp(-_per_env(_row(_FOG_DENSITY, weather_idx), dist) * dist)
    lead = (slice(None),) + (None,) * (dist.dim() - 1)
    return lit * (1.0 - f[..., None]) + fog_color(weather_idx)[lead] * f[..., None]


def wet_darken(weather_idx: torch.Tensor, road_color: torch.Tensor) -> torch.Tensor:
    """road_color [3] -> [E, 3]."""
    wet = _row(_WET, weather_idx)[:, None]
    return road_color * (1.0 - 0.35 * wet)


def hash_sin(x: torch.Tensor, a: float, y: torch.Tensor) -> torch.Tensor:
    """sin(x*a + y) in float32 with the argument rounded once, as XLA
    contracts it into a fused multiply-add under jit, and sin correctly
    rounded.

    The hashes feed sin(.) * 43758.5 with arguments up to about 1e5, where one
    rounding step of the argument, or one ulp of sin, moves the noise value
    by up to its whole range. x*a is exact in float64 (x and a are float32),
    so the float64 sum rounded once to float32 is the FMA's result; sin is
    then taken in float64 and rounded once.

    The argument matches XLA's; sin does not always. XLA:CPU's float32 sin,
    jitted, is glibc's ``sinf`` bit for bit, and ``sinf`` is not correctly
    rounded: on the rain hash's arguments (``x`` the integers 0-199,999) it
    differs from this function by one ulp on 1.3% of them, and a streak
    column's phase with it (ROADMAP Queue 3; tests/test_torch_render.py pins
    the share). Matching it would take glibc's range reduction and
    polynomial, in the FMA variant its ifunc picks; a float32 sin on the
    card (CUDA's ``sinf``) would differ again."""
    a32 = torch.tensor(a, dtype=torch.float32).item()
    arg = (x.double() * a32 + y.double()).float()
    return torch.sin(arg.double()).float()


def _hash01(x: torch.Tensor) -> torch.Tensor:
    """Cheap per-element hash -> [0, 1) float noise."""
    h = hash_sin(x, 12.9898, torch.full_like(x, 78.233)) * 43758.5453
    return h - torch.floor(h)


def rain_streaks(
    weather_idx: torch.Tensor,
    u: torch.Tensor,  # [H, W] pixel column coords 0..1
    v: torch.Tensor,  # [H, W] pixel row coords 0..1
    time_s: torch.Tensor,  # [E]
    color: torch.Tensor,  # [E, H, W, 3]
) -> torch.Tensor:
    """Overlay falling streaks; intensity from the weather table."""
    strength = _per_env(_row(_RAIN, weather_idx), color)
    t = time_s[:, None, None]
    col = torch.floor(u * 60.0)
    phase = _hash01(col)
    fall = torch.remainder(v * 2.5 + t * 1.7 + phase, 1.0)  # [E, H, W]
    streak = (fall < 0.12) & (_hash01(col + torch.floor(t * 1.7)) > 0.5)
    overlay = torch.where(streak[..., None], 0.75, 0.0)
    a = 0.35 * strength
    return color * (1.0 - a * (overlay > 0)) + overlay * a


def headlight(
    weather_idx: torch.Tensor,
    u: torch.Tensor,  # [H, W] 0..1
    v: torch.Tensor,
    dist: torch.Tensor,  # [E, H, W] ground distance
    color: torch.Tensor,  # [E, H, W, 3]
) -> torch.Tensor:
    """Night: brighten a cone ahead of the car (lower-center of the image)."""
    night = _per_env(_row(_NIGHT, weather_idx), dist)
    cone = torch.exp(-((u - 0.5) ** 2) / 0.03) * torch.clamp((v - 0.45) * 2.2, 0.0, 1.0)
    near = torch.exp(-dist / 25.0)
    boost = 1.0 + night * 2.6 * cone * near
    return color * boost[..., None]
