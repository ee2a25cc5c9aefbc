"""Headline benchmark of the port: closed-loop env-steps/s of a drive-mode
fleet (port of ``bench.py``).

    python -m cilrs_tpu_torch.bench.env_steps [--device cpu]
    torchrun --nproc_per_node N -m cilrs_tpu_torch.bench.env_steps

One env step is the render (88x200 raycast camera), the CILRS forward
batched over the fleet, perception, the safety cascade, NPC traffic, physics
and metrics: ``agent/driver.py:fleet_rollout`` in drive mode without frames.
The fleet is ``bench.py``'s (``make_bench_fleet``): the 3x3-block mini town,
one spawned world (12 vehicles, 5 walkers) and one chained pool of 3 routes
from ``RandomState(0)``, one driver state broadcast over the envs, env e in
weather e % 5, the full-width CILRS with dropout 0 and random weights from a
seeded ``torch.Generator`` (bf16 autocast, ``channels_last`` on the card).
The pedestrians' draws come from a seeded generator on the device, drawn
inside each chunk.

``BENCH_ENVS`` (128), ``BENCH_TICKS`` (50) and ``BENCH_REPS`` (5) are read
from the environment, as ``bench.py`` reads them. One warm-up chunk runs
first: the kernels' build and its seconds go to stderr apart. Then ``REPS``
chunks are timed with one synchronize at the end; no step of a chunk reads
the device from the host. Under torchrun each rank runs its block of the
envs (``parallel.fleet.make_sharded_rollout``) and the rate is divided by
the world size.

Prints ONE JSON line: ``{"metric", "value", "unit", "device", "card",
"power_limit"}``. ``bench.py``'s ``vs_baseline`` is left out: its baseline
is a TPU pod's per-chip target, and no TPU number is a target of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from cilrs_tpu_torch.agent.driver import DriverState, fleet_rollout, make_driver_state, model_policy
from cilrs_tpu_torch.agent.npc import draw_pedestrians
from cilrs_tpu_torch.agent.scenario import spawn_world
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import (ModelConfig, TrainConfig, WEATHER_NAMES, WeatherTable,
                                    load_weather_table)
from cilrs_tpu_torch.core.convert import pool_from_arrays, world_from_arrays
from cilrs_tpu_torch.core.state import VehicleParams, default_vehicle_params, tree_map
from cilrs_tpu_torch.maps.network import RoadNetwork
from cilrs_tpu_torch.maps.routing import RoutePool, chained_route_pool
from cilrs_tpu_torch.maps.town import make_town01

METRIC = "env_steps_per_sec_per_chip"
NUM_VEHICLES, NUM_PEDESTRIANS, NUM_ROUTES = 12, 5, 3
TOWN_BLOCKS = 3  # make_town01(blocks_x=3, blocks_y=3)
SEED = 0  # the host's RandomState, the policy's init and the draws' generator


def bench_shape() -> tuple[int, int, int]:
    """(envs, ticks a chunk, timed chunks) from the environment, as bench.py
    reads them."""
    return (int(os.environ.get("BENCH_ENVS", "128")), int(os.environ.get("BENCH_TICKS", "50")),
            int(os.environ.get("BENCH_REPS", "5")))


@dataclasses.dataclass
class BenchFleet:
    """bench.py's fleet on one device and the chunk that advances it."""

    net: RoadNetwork
    pool: RoutePool  # the shared pool, [K, R, ...]
    wt: WeatherTable
    params: VehicleParams
    policy: object
    generator: torch.Generator
    state: DriverState
    ticks: int
    sharded: object = None  # parallel.fleet.make_sharded_rollout's call, under torchrun

    def chunk(self) -> DriverState:
        """``ticks`` ticks of drive mode; returns the new state (no outputs
        are kept: bench.py's chunk returns its final state alone)."""
        w = self.state.world
        E = w.num_envs
        draws = draw_pedestrians(self.generator, self.ticks, E, w.num_pedestrians,
                                 w.veh_pos.device)
        if self.sharded is not None:
            self.state, _ = self.sharded(self.state, self.net, self.pool, draws)
        else:
            pool = tree_map(lambda x: x.expand((E,) + x.shape), self.pool)
            self.state, _ = fleet_rollout(self.state, self.ticks, self.net, pool, self.wt,
                                          self.params, draws, mode="drive", policy=self.policy,
                                          want_frames=False)
        return self.state


def bench_policy(device):
    """The CILRS of bench.py as a fleet policy: the full width with dropout
    0, random weights from ``SEED``, in eval mode; bf16 autocast and
    ``channels_last`` on the card."""
    from cilrs_tpu_torch.train.state import create_train_state

    cfg = TrainConfig(model=ModelConfig(dropout=0.0))
    return model_policy(create_train_state(cfg, SEED, device=device).model.eval())


def make_bench_fleet(num_envs: int, ticks: int, device="cuda", mesh=None) -> BenchFleet:
    """bench.py's fleet of ``num_envs`` envs (``bench.py:55-66``) on
    ``device``. With a ``parallel.mesh.Mesh``, each chunk runs the rank's
    block of the envs and all-gathers the final state."""
    dev = require_cuda(device)
    net = make_town01(blocks_x=TOWN_BLOCKS, blocks_y=TOWN_BLOCKS)
    rng = np.random.RandomState(SEED)
    pool = chained_route_pool(net, rng, num_routes=NUM_ROUTES)
    world = spawn_world(net, NUM_VEHICLES, NUM_PEDESTRIANS, rng)
    worlds = world_from_arrays([world] * num_envs, dev)
    worlds = worlds.replace(weather_idx=torch.arange(num_envs, device=dev) % len(WEATHER_NAMES))
    wt, params = load_weather_table(device=dev), default_vehicle_params(dev)
    policy = bench_policy(dev)
    sharded = None
    if mesh is not None:
        from cilrs_tpu_torch.parallel.fleet import make_sharded_rollout

        sharded = make_sharded_rollout(mesh, ticks, wt, params, policy=policy, mode="drive",
                                       want_frames=False)
    return BenchFleet(net=net.to(dev), pool=tree_map(lambda x: x[0], pool_from_arrays([pool], dev)),
                      wt=wt, params=params, policy=policy,
                      generator=torch.Generator(device=dev).manual_seed(SEED),
                      state=make_driver_state(worlds), ticks=ticks, sharded=sharded)


def synchronize(dev: torch.device):
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_fields(dev: torch.device) -> dict:
    """The device a result was measured on; on the card, its name and power
    limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return {"device": "cpu", "card": None, "power_limit": None}
    from cilrs_tpu_torch.bench.timing import card_line

    name, limit = card_line().rsplit(", ", 1)
    return {"device": "cuda", "card": name, "power_limit": limit}


def run(num_envs: int, ticks: int, reps: int, device="cuda",
        mesh=None) -> tuple[dict, dict, BenchFleet]:
    """Build the fleet, run one warm-up chunk and time ``reps`` chunks.
    Returns (the JSON line, the run's times, the fleet)."""
    dev = require_cuda(device)
    build_s = 0.0
    if dev.type == "cuda":  # the sin-hash kernel's first build, timed apart
        from cilrs_tpu_torch.ops.build import build

        t0 = time.time()
        build(["hash_sinf"])
        build_s = time.time() - t0
    t0 = time.time()
    fleet = make_bench_fleet(num_envs, ticks, dev, mesh)
    setup_s = time.time() - t0
    t0 = time.time()
    fleet.chunk()
    synchronize(dev)
    first_s = time.time() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        fleet.chunk()
    issue_s = time.perf_counter() - t0  # the host's time to issue the chunks
    synchronize(dev)
    wall_s = time.perf_counter() - t0
    world = 1 if mesh is None else mesh.world
    rate = num_envs * ticks * reps / wall_s / world  # per chip: the fleet shards evenly
    line = {"metric": METRIC, "value": round(rate, 1),
            "unit": f"env-steps/s (render+policy+dynamics, per chip of {world})",
            **device_fields(dev)}
    times = {"envs": num_envs, "ticks": ticks, "reps": reps, "world": world,
             "kernel_build_s": build_s, "setup_s": setup_s, "first_chunk_s": first_s,
             "wall_s": wall_s, "issue_s": issue_s,
             "env_steps_per_s": num_envs * ticks * reps / wall_s,
             "ms_per_tick": wall_s * 1e3 / (reps * ticks),
             "host_issue_ms_per_tick": issue_s * 1e3 / (reps * ticks)}
    return line, times, fleet


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="closed-loop env-steps/s of bench.py's drive fleet "
                                            "(PyTorch/CUDA)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)
    from cilrs_tpu_torch.parallel.distributed import initialize_distributed, is_coordinator
    from cilrs_tpu_torch.parallel.mesh import make_mesh

    mesh = None
    if initialize_distributed(device=dev):  # first: it sets this rank's GPU
        mesh = make_mesh(device=dev.type)
        dev = mesh.device
    E, T, REPS = bench_shape()
    line, times, _ = run(E, T, REPS, dev, mesh=mesh)
    if is_coordinator():
        if dev.type == "cuda":
            print(f"# kernel build: {times['kernel_build_s']:.1f}s", file=sys.stderr)
        print(f"# first chunk: {times['first_chunk_s']:.1f}s", file=sys.stderr)
        print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
