"""The JAX package's simulator state, given as numpy arrays, into the port's
batched tensors.

The JAX package holds one env per pytree (``vmap`` adds the env axis); the
port holds the fleet, with a leading env dimension E. These functions stack E
per-env states, each given as a dict of numpy arrays named as the fields
(nested dicts for nested states), into the port's dataclasses. Integer fields
become int64 (for indexing), floats float32, bools bool; keys the port has no
field for (the JAX world's PRNG key) are ignored. The tests start both
packages from identical states with them, and the host-side setup of
``data/collect.py`` stacks its traced route pools and spawned worlds with
them. A network needs no stacking: ``RoadNetwork.from_arrays`` takes the JAX
network's arrays as they are.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from portbench.reference.frozen.agent.driver import DriverState
from portbench.reference.frozen.core.state import WorldState
from portbench.reference.frozen.maps.routing import RoutePool


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    kind = a.dtype.kind
    dtype = {"b": torch.bool, "i": torch.int64, "u": torch.int64}.get(kind, torch.float32)
    return torch.as_tensor(a.astype(np.int64) if kind in "iu" else a).to(device, dtype)


def stack_arrays(cls, items: list[dict], device="cpu"):
    """A ``cls`` dataclass whose fields stack ``items[e][field]`` along a new
    leading env dimension, recursing into nested dataclass fields."""
    hints = typing.get_type_hints(cls)
    fields = {}
    for f in dataclasses.fields(cls):
        sub = hints[f.name]
        parts = [item[f.name] for item in items]
        if dataclasses.is_dataclass(sub):
            fields[f.name] = stack_arrays(sub, parts, device)
        else:
            fields[f.name] = _tensor(np.stack([np.asarray(p) for p in parts]), device)
    return cls(**fields)


def pool_from_arrays(pools: list[dict], device="cpu") -> RoutePool:
    """The fleet's route pools [E, K, R, ...] from E per-env pools."""
    return stack_arrays(RoutePool, pools, device)


def world_from_arrays(worlds: list[dict], device="cpu") -> WorldState:
    """The fleet's WorldState from E per-env worlds."""
    return stack_arrays(WorldState, worlds, device)


def driver_state_from_arrays(states: list[dict], device="cpu") -> DriverState:
    """The fleet's DriverState from E per-env driver states (nested dicts:
    world, ctrl with its smoothing, metrics)."""
    return stack_arrays(DriverState, states, device)
