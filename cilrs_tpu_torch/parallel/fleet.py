"""Sharded fleet execution: the env batch spread over the ranks (port of
``cilrs_tpu/parallel/fleet.py``).

``agent/driver.py:fleet_rollout`` is batch-first code; here each rank runs
it on its contiguous block of the envs, with the policy replicated. Every env
is independent, so the rollout itself needs no collective; the results are
all-gathered at the end, so that every rank returns the global view that
JAX's global arrays give.

The pedestrians' draws are one [T, E, P] tensor for the whole fleet: every
rank takes the global tensor and keeps its block, so an env's draws do not
depend on the world size.

``donate`` has no counterpart: the port updates no caller's tensor in place
that the caller could reuse, and keeps no compiled program to donate into.
"""

from __future__ import annotations

import dataclasses

import torch

from cilrs_tpu_torch.agent.driver import DriverState, fleet_rollout
from cilrs_tpu_torch.config import WeatherTable
from cilrs_tpu_torch.core.state import VehicleParams, tree_map
from cilrs_tpu_torch.data.collect import CollectFleet
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.maps.routing import RoutePool
from cilrs_tpu_torch.parallel.mesh import Mesh, all_gather, block, shard_batch
from cilrs_tpu_torch.render.camera import CameraSpec
from cilrs_tpu_torch.render.raster import CAMERA


def _num_envs(tree) -> int:
    out = []
    tree_map(out.append, tree)
    return out[0].shape[0]


def pad_fleet_to_mesh(fleet: DriverState, mesh: Mesh) -> tuple[DriverState, int]:
    """Pad the env axis up to a multiple of the world size, repeating env 0;
    returns (padded fleet, original size)."""
    E = _num_envs(fleet)
    pad = (-E) % mesh.world
    if pad == 0:
        return fleet, E
    return tree_map(lambda x: torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]), fleet), E


def shard_collect_fleet(fleet: CollectFleet, mesh: Mesh) -> CollectFleet:
    """The rank's block of a collect fleet: its envs' state and pools; its
    chunks draw the whole fleet's pedestrian draws and keep the block's."""
    E = fleet.state.world.num_envs
    return dataclasses.replace(fleet, state=shard_batch(mesh, fleet.state),
                               pool=shard_batch(mesh, fleet.pool), draw_envs=E,
                               env_block=block(mesh, E))


def make_sharded_rollout(
    mesh: Mesh,
    steps: int,
    wt: WeatherTable,
    params: VehicleParams,
    policy=None,
    mode: str = "drive",
    cam: CameraSpec = CAMERA,
    want_frames: bool = False,
    loop_routes: bool = True,
    pool_batched: bool = False,
):
    """A (fleet, net, pool, ped_draws) -> (fleet', outputs) rollout of
    ``steps`` ticks with the env axis sharded over the ranks.

    ``fleet`` [E, ...] and ``ped_draws`` [T, E, P] are global: each rank pads
    them to a multiple of the world size (env 0 repeated, its draws with it),
    keeps its block and runs ``fleet_rollout``. ``pool`` is one shared pool
    ([K, R, ...], each rank broadcasts it over its block) or, with
    ``pool_batched``, the fleet's [E, K, R, ...], sharded like the fleet.
    ``policy`` (drive mode) is the replicated policy of ``fleet_rollout``,
    the JAX function's ``apply_fn`` with its variables. Returns the global
    final state [E, ...] and outputs, stacked [E, T, ...] as
    ``fleet_rollout`` stacks them (JAX's are [T, E, ...]); the frames only
    with ``want_frames``."""

    def call(fleet: DriverState, net: RoadNetwork, pool: RoutePool, ped_draws: torch.Tensor):
        fleet, E = pad_fleet_to_mesh(fleet, mesh)
        padded = _num_envs(fleet)
        draws = torch.cat([ped_draws, ped_draws[:, :1].expand(
            -1, padded - E, -1)], dim=1)[:, block(mesh, padded)]
        local = shard_batch(mesh, fleet)
        n = _num_envs(local)
        if pool_batched:
            pool = shard_batch(mesh, pad_fleet_to_mesh(pool, mesh)[0])
        else:
            pool = tree_map(lambda x: x.expand((n,) + x.shape), pool)
        final, outs = fleet_rollout(local, steps, net, pool, wt, params, draws, mode=mode, cam=cam,
                                    policy=policy, loop_routes=loop_routes,
                                    want_frames=want_frames)
        final, outs = all_gather(mesh, (final, outs))
        if padded != E:
            final = tree_map(lambda x: x[:E], final)
            outs = {k: v[:E] for k, v in outs.items()}
        return final, outs

    return call
