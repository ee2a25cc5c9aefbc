"""The headline fleet: ``bench/env_steps.py:BenchFleet.chunk`` in drive mode,
no frames kept, on a fleet built from the seed as ``make_bench_fleet`` builds
it (the map, a chained route pool and one spawned world broadcast over the
envs, env e in weather e % 5, the configuration's policy architecture at its
widths, and its camera).

Window: chunks of ``ticks`` ticks, each issued and then synchronised, until
``--seconds`` have passed; ``env_steps_per_s`` is envs x ticks of the
window's chunks over its wall. Traced run: the same window (its issue times
and rate), then one profiled chunk of ``profile_ticks`` with the tick's
layers in ranges. Check: one more chunk of the window's entry, recorded tick
by tick, which the reference follows on a sample of its ticks.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench import faults, simrun, trace
from portbench.harness import sync, window
from portbench.reference import sim as ref_sim


def build(ctx, fp32=False):
    """The program's fleet for this run, and its map, pool and first world."""
    from cilrs_tpu_torch.agent.driver import make_driver_state
    from cilrs_tpu_torch.agent.scenario import spawn_world
    from cilrs_tpu_torch.bench.env_steps import BenchFleet
    from cilrs_tpu_torch.config import load_weather_table
    from cilrs_tpu_torch.core.convert import pool_from_arrays, world_from_arrays
    from cilrs_tpu_torch.core.state import default_vehicle_params, tree_map
    from cilrs_tpu_torch.maps.routing import chained_route_pool
    from cilrs_tpu_torch.maps.town import make_town01

    dev, sim, tr = ctx.device, ctx.config["sim"], ctx.traffic
    E = tr["envs"]
    net = make_town01(blocks_x=sim["town_blocks"][0], blocks_y=sim["town_blocks"][1])
    rng = np.random.RandomState(ctx.seed_for(1))
    pool = chained_route_pool(net, rng, num_routes=sim["routes"])
    world = spawn_world(net, sim["vehicles"], sim["walkers"], rng)
    worlds = world_from_arrays([world] * E, dev)
    worlds = worlds.replace(weather_idx=torch.arange(E, device=dev) % sim["weathers"])
    policy, sd = simrun.program_policy(ctx, fp32)
    fleet = BenchFleet(net=net.to(dev), pool=tree_map(lambda x: x[0], pool_from_arrays([pool], dev)),
                       wt=load_weather_table(device=dev), params=default_vehicle_params(dev),
                       policy=policy, state=make_driver_state(worlds), ticks=tr["ticks"],
                       generator=torch.Generator(device=dev).manual_seed(ctx.seed_for(3)))
    simrun.keep_carry(fleet, ctx, policy)
    simrun.set_camera(fleet, simrun.camera(sim))
    return fleet, sd


def prepare(ctx, fp32=False):
    """Set-up: the fleet, the run's weights and the start the reference
    checks (map, the pool over the envs, the first world), after the
    warm-up chunks."""
    from cilrs_tpu_torch.core.state import tree_map

    E = ctx.traffic["envs"]
    fleet, sd = build(ctx, fp32)
    start = (fleet.net, tree_map(lambda x: x.expand((E,) + x.shape), fleet.pool), fleet.state.world)
    for _ in range(ctx.traffic["warmup_chunks"]):
        fleet.chunk()
    sync(ctx.device)
    return fleet, sd, start


def run(ctx) -> dict:
    dev, tr = ctx.device, ctx.traffic
    E, T = tr["envs"], tr["ticks"]
    fleet, sd, start = prepare(ctx)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = window(ctx, fleet.chunk)
    env_steps = E * T * win["chunks"]
    rate = env_steps / win["wall_s"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = {"issue_ms_per_unit": win["issue_s"] * 1e3 / (T * win["chunks"]),
           "wall_ms_per_unit": win["wall_s"] * 1e3 / (T * win["chunks"]),
           "mfu_pct": simrun.mfu_pct(ctx, rate)}
    if ctx.trace:
        short = dataclasses.replace(fleet, ticks=tr["profile_ticks"])
        prof = trace.profile(short.chunk, tr["profile_ticks"], simrun.tick_ranges(short))
        fleet.state = short.state
        rec.update(prof)
    ticks, hashes = simrun.record_chunk(fleet.chunk, fleet)
    sync(dev)
    rec.update(simrun.hash_roofline_rec(rec, hashes, T) if ctx.trace else {})
    finite = simrun.finite_state(fleet.state)
    del fleet

    got, lim = readings(ctx, sd, start, ticks), ctx.workload["limits"]
    return {"e2e": {"env_steps_per_s": rate}, "rec": rec, "attempted": win["chunks"],
            "failed": 0 if finite else win["chunks"], "memory_peak_bytes": peak,
            "checked": {k: (got[k], lim[k]) for k in lim}}


def readings(ctx, sd, start, ticks, quant=False) -> dict:
    policy = ref_sim.reference_policy(ctx.config["model"], sd, ctx.device, quant)
    ref = ref_sim.bench_start(ctx.config["sim"], ctx.traffic["envs"], ctx.seed_for(1), policy,
                              ctx.device)
    sample = simrun.sample_ticks(len(ticks), ctx.traffic["check_ticks"], ctx.seed_for(4))
    out = ref_sim.follow(ref, start[1], ticks, sample, loop_routes=True, quant=quant)
    out["start_mismatch"] = ref_sim.start_mismatch(ref, *start)
    return out


def calibrate(ctx, control=True, fault=None, fp32=False) -> dict:
    """The check's readings of the program (with ``fault`` planted, if any,
    or its policy in float32 with ``fp32``) and of the control on one seed,
    after the warm-up and without a window."""
    fleet, sd, start = prepare(ctx, fp32)
    with faults.sim_fault(fault, fleet) if fault else contextlib.nullcontext():
        ticks, _ = simrun.record_chunk(fleet.chunk, fleet)
    del fleet
    out = {"program": readings(ctx, sd, start, ticks)}
    if control:
        out["control"] = readings(ctx, sd, start, ticks, quant=True)
    return out
