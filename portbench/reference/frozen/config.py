"""Training and model configuration, loaded from the shared ``configs/train.json``.

A copy of the plain dataclasses of ``cilrs_tpu/config.py`` (that module imports
JAX for its device-side weather table, so the port keeps its own), plus the
per-weather ``WeatherTable`` as [num_weathers] tensors on a device, read from
the shared ``configs/weather.json`` and indexed by each env's weather index.
``ScoringConfig`` holds the closed-loop scoring weights and grades of the
shared ``configs/weather.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

WEATHER_NAMES = ("clear", "rain", "fog", "night", "hardrain")
COMMAND_NAMES = ("LANEFOLLOW", "LEFT", "RIGHT", "STRAIGHT")

# Speed normalization factor (reference autonomous_drive.py:485, collect_data.py:675).
SPEED_NORM_FACTOR = 90.0


def _load_json(name: str, override_path: str | None = None) -> dict[str, Any]:
    path = override_path or os.path.join(_CONFIG_DIR, name)
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class WeatherTable:
    """Per-weather controller parameters as stacked [W] float32 tensors."""

    max_speed_kmh: torch.Tensor
    curve_speed_kmh: torch.Tensor
    sharp_curve_speed_kmh: torch.Tensor
    brake_factor: torch.Tensor
    steer_damping: torch.Tensor
    curve_lookahead: torch.Tensor
    curve_threshold: torch.Tensor
    sharp_threshold: torch.Tensor
    traction_control: torch.Tensor
    traction_speed_threshold_kmh: torch.Tensor
    friction: torch.Tensor

    @property
    def num_weathers(self) -> int:
        return self.max_speed_kmh.shape[0]


@dataclasses.dataclass(frozen=True)
class ObstacleConfig:
    """The obstacle corridor (``agent/perception.py:get_obstacle_distance``).
    The two actor-cache fields are the reference's and read by nothing: every
    actor is scanned every frame."""
    lateral_threshold_m: float = 2.5
    forward_dot_threshold: float = 0.5
    max_detection_range_m: float = 20.0
    min_detection_range_m: float = 0.5
    actor_cache_refresh_frames: int = 5
    actor_cache_radius_m: float = 25.0


@dataclasses.dataclass(frozen=True)
class TrafficLightConfig:
    """The light gating (``agent/perception.py:check_traffic_light``,
    ``red_light_ahead``)."""
    max_obey_distance_m: float = 15.0
    heading_dot_threshold: float = 0.3


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    collision_penalty: float = 15.0
    red_light_violation_penalty: float = 10.0
    off_road_penalty_factor: float = 40.0
    safety_weight: float = 0.6
    comfort_weight: float = 0.3
    route_completion_weight: float = 0.1
    comfort_jerk_factor: float = 1000.0
    grades: tuple = (("A+", 90.0), ("A", 80.0), ("B+", 70.0), ("B", 60.0))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: str = "resnet34"
    num_commands: int = 4
    dropout: float = 0.5
    image_height: int = 88
    image_width: int = 200
    speed_normalization: float = SPEED_NORM_FACTOR
    # ResNet stage depths; (1, 1, 1, 1) gives a fast "resnet10" for tests.
    stage_sizes: tuple = (3, 4, 6, 3)
    # Speed-aware head (dropout-free speed encoder + per-command linear speed
    # skip). False reproduces the reference architecture exactly.
    speed_skip: bool = True


@dataclasses.dataclass(frozen=True)
class LossConfig:
    steer_weight: float = 5.0
    throttle_weight: float = 1.0
    brake_weight: float = 1.0
    speed_weight: float = 0.5


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    gradient_clip: float = 1.0
    lr_step_epochs: int = 8
    lr_step_gamma: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 120
    epochs: int = 20
    val_fraction: float = 0.15
    early_stop_patience: int = 6
    seed: int = 42
    compute_dtype: str = "bfloat16"
    # Extra sampling weight on big-steer/braking frames (0 = reference parity).
    hard_frame_boost: float = 0.0
    # Evaluate/deploy a Polyak average of the params instead of the raw iterate.
    ema_eval: bool = True
    # TRAIN-only multipliers on the aux speed-head MSE and brake-head L1
    # weights; reported losses keep the canonical LossConfig weights.
    speed_loss_boost: float = 1.0
    brake_loss_boost: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    training: TrainingConfig = TrainingConfig()


def _sub(cls, d: dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


def load_train_config(path: str | None = None) -> TrainConfig:
    raw = _load_json("train.json", path)
    return TrainConfig(
        model=_sub(ModelConfig, raw.get("model", {})),
        loss=_sub(LossConfig, raw.get("loss", {})),
        optimizer=_sub(OptimizerConfig, raw.get("optimizer", {})),
        training=_sub(TrainingConfig, raw.get("training", {})),
    )


def load_weather_config(path: str | None = None) -> dict[str, Any]:
    return _load_json("weather.json", path)


def load_weather_table(path: str | None = None, device="cpu") -> WeatherTable:
    raw = load_weather_config(path)["weather_profiles"]
    missing = [w for w in WEATHER_NAMES if w not in raw]
    if missing:
        raise ValueError(f"weather config missing profiles: {missing}")

    def col(field: str) -> torch.Tensor:
        vals = [float(raw[w][field]) for w in WEATHER_NAMES]  # bools become 1.0 / 0.0
        return torch.tensor(vals, dtype=torch.float32, device=device)

    return WeatherTable(**{f.name: col(f.name) for f in dataclasses.fields(WeatherTable)})


def load_obstacle_config(path: str | None = None) -> ObstacleConfig:
    return _sub(ObstacleConfig, load_weather_config(path).get("obstacle_detection", {}))


def load_traffic_light_config(path: str | None = None) -> TrafficLightConfig:
    return _sub(TrafficLightConfig, load_weather_config(path).get("traffic_light", {}))


def load_scoring_config(path: str | None = None) -> ScoringConfig:
    raw = load_weather_config(path).get("scoring", {})
    grades = raw.pop("grades", None)
    cfg = _sub(ScoringConfig, raw)
    if grades:
        cfg = dataclasses.replace(cfg, grades=tuple(sorted(grades.items(), key=lambda kv: -kv[1])))
    return cfg


def weather_index(name: str) -> int:
    name = name.lower().replace("_", "").replace("-", "")
    aliases = {"hardrain": "hardrain", "hard": "hardrain", "clearnoon": "clear"}
    name = aliases.get(name, name)
    if name not in WEATHER_NAMES:
        raise ValueError(f"unknown weather {name!r}; expected one of {WEATHER_NAMES}")
    return WEATHER_NAMES.index(name)
