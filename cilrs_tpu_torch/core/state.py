"""World state as dataclasses of tensors (port of ``cilrs_tpu/core/state.py``).

The JAX package keeps one env's state in a pytree and ``vmap``s over envs.
Here every field carries a leading env dimension ``E`` and each function works
on the whole fleet at once. Vehicle 0 of each env is the ego; 1..V-1 are NPC
traffic.

There is no PRNG key in the state: the fleet's random draws (the pedestrians'
re-aim) come from an explicit ``torch.Generator`` or from a tensor of draws
given to the rollout (``agent/driver.py``).
"""

from __future__ import annotations

import dataclasses

import torch


class TensorTree:
    """A dataclass whose leaves are tensors or nested ``TensorTree``s."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tree_map(fn, tree, *rest):
    """Apply fn leaf by leaf over one or more trees of the same structure."""
    if isinstance(tree, TensorTree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name),
                                              *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in ``tree_map``'s order."""
    if isinstance(tree, TensorTree):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (``tree_leaves``'s
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_where(cond: torch.Tensor, a, b):
    """Per env: leaves of a where cond [E] holds, else of b."""
    def pick(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)
    return tree_map(pick, a, b)


@dataclasses.dataclass(frozen=True)
class VehicleParams(TensorTree):
    """Kinematic-bicycle + longitudinal parameters (0-d float32 tensors, as
    the JAX package's float32 scalars).

    Tuned so cruise behavior matches the reference protocol: ~35 km/h cruise,
    45 km/h hard cap, 20 Hz tick.
    """

    wheelbase: torch.Tensor  # m
    max_steer_rad: torch.Tensor  # front-wheel angle at |steer|=1
    max_accel: torch.Tensor  # m/s^2 at throttle=1
    max_brake_decel: torch.Tensor  # m/s^2 at brake=1
    max_reverse_speed: torch.Tensor  # m/s
    drag_c0: torch.Tensor  # constant rolling resistance, m/s^2
    drag_c1: torch.Tensor  # linear drag coefficient, 1/s
    length: torch.Tensor  # bounding-box length, m
    width: torch.Tensor  # bounding-box width, m


def default_vehicle_params(device="cpu") -> VehicleParams:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return VehicleParams(
        wheelbase=f32(2.9),
        max_steer_rad=f32(0.6109),  # 35 degrees
        max_accel=f32(4.0),
        max_brake_decel=f32(8.0),
        max_reverse_speed=f32(5.0),
        drag_c0=f32(0.15),
        drag_c1=f32(0.08),
        length=f32(4.7),
        width=f32(2.0),
    )


@dataclasses.dataclass(frozen=True)
class WorldState(TensorTree):
    """The full dynamic state of E envs. V vehicles (ego at 0), P pedestrians."""

    veh_pos: torch.Tensor  # [E, V, 2] world xy, m
    veh_yaw: torch.Tensor  # [E, V] rad
    veh_speed: torch.Tensor  # [E, V] m/s, signed (negative while reversing)
    veh_alive: torch.Tensor  # [E, V] bool
    veh_control: torch.Tensor  # [E, V, 3] last applied (steer, throttle, brake)
    veh_reverse: torch.Tensor  # [E, V] bool — gear selection
    veh_wp: torch.Tensor  # [E, V] int64 — current lane-graph waypoint (NPC AI)
    veh_target_speed: torch.Tensor  # [E, V] m/s — NPC cruise targets

    ped_pos: torch.Tensor  # [E, P, 2]
    ped_yaw: torch.Tensor  # [E, P]
    ped_speed: torch.Tensor  # [E, P] m/s
    ped_alive: torch.Tensor  # [E, P] bool

    time_s: torch.Tensor  # [E] float32 sim time, accumulated tick by tick
    step: torch.Tensor  # [E] int64
    weather_idx: torch.Tensor  # [E] int64 into the WeatherTable

    @property
    def num_envs(self) -> int:
        return self.veh_pos.shape[0]

    @property
    def num_vehicles(self) -> int:
        return self.veh_pos.shape[1]

    @property
    def num_pedestrians(self) -> int:
        return self.ped_pos.shape[1]

    @property
    def ego_pos(self) -> torch.Tensor:
        return self.veh_pos[:, 0]

    @property
    def ego_yaw(self) -> torch.Tensor:
        return self.veh_yaw[:, 0]

    @property
    def ego_speed(self) -> torch.Tensor:
        return self.veh_speed[:, 0]


def make_world(num_envs: int, num_vehicles: int, num_pedestrians: int,
               weather_idx: int = 0, device="cpu") -> WorldState:
    """Blank worlds with every actor at the origin and only the ego alive.

    Scenario setup is ``agent.scenario.spawn_world``; this is the container.
    """
    E, V, P = num_envs, num_vehicles, num_pedestrians
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    alive = torch.zeros((E, V), dtype=torch.bool, device=device)
    alive[:, 0] = True
    return WorldState(
        veh_pos=z(E, V, 2), veh_yaw=z(E, V), veh_speed=z(E, V), veh_alive=alive,
        veh_control=z(E, V, 3),
        veh_reverse=torch.zeros((E, V), dtype=torch.bool, device=device),
        veh_wp=torch.zeros((E, V), dtype=torch.int64, device=device),
        veh_target_speed=torch.full((E, V), 30.0 / 3.6, dtype=torch.float32, device=device),
        ped_pos=z(E, P, 2), ped_yaw=z(E, P), ped_speed=z(E, P),
        ped_alive=torch.zeros((E, P), dtype=torch.bool, device=device),
        time_s=z(E),
        step=torch.zeros(E, dtype=torch.int64, device=device),
        weather_idx=torch.full((E,), weather_idx, dtype=torch.int64, device=device),
    )
