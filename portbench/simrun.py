"""What the fleet and drive drivers share: the program's CILRS with the run's
weights, the tick's layer ranges, the hash calls of a tick, and the record of
a chunk that the reference follows (``reference/sim.py``)."""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from portbench import counts, trace
from portbench.weights import load_into, seeded_state_dict

# The sin-hash entry points as their callers look them up: (module path,
# attribute, entry point).
HASH_SITES = (("cilrs_tpu_torch.render.weather", "hash01", "hash01"),
              ("cilrs_tpu_torch.render.raster", "grain_texture", "grain_texture"),
              ("cilrs_tpu_torch.agent.driver", "reverse_steer", "reverse_steer"))


def program_policy(model_cfg: dict, seed: int, device, fp32: bool = False):
    """The program's CILRS in eval mode, as the drive CLIs build it
    (``train.state.create_train_state``: bf16 autocast and ``channels_last``
    on the card, the CLIs' float32 settings), holding the run's weights.
    ``fp32`` turns its autocast off: a witness for the check, never a run."""
    from cilrs_tpu_torch.config import ModelConfig, TrainConfig
    from cilrs_tpu_torch.train.state import create_train_state

    cfg = TrainConfig(model=ModelConfig(dropout=0.0, num_commands=model_cfg["num_commands"],
                                        stage_sizes=tuple(model_cfg["stage_sizes"]),
                                        speed_skip=model_cfg["speed_skip"]))
    model = create_train_state(cfg, seed, device=device).model.eval()
    if fp32:
        model.dtype = torch.float32
    sd = seeded_state_dict(model_cfg, seed, device)
    load_into(model, sd)
    return model, sd


def tick_ranges(owner) -> list:
    """The tick's layers in profiler ranges: observation, render, policy
    (``owner.policy``), action, NPCs, physics."""
    from cilrs_tpu_torch.agent import driver

    return [(driver, "env_observe", "env_observe"), (driver, "render_frame", "render_frame"),
            (owner, "policy", "policy"), (driver, "env_act", "env_act"),
            (driver, "npc_controller", "npc_controller"),
            (driver, "world_physics_step", "world_physics_step")]


def record_chunk(chunk, owner) -> tuple[list[dict], list[tuple[str, int]]]:
    """Run ``chunk()`` with taps on the tick's observation, policy and action;
    returns each tick's {"state", "frame", "controls", "draws", "next"} and
    the sin-hash calls it made as (entry point, elements)."""
    from cilrs_tpu_torch.agent import driver

    ticks: list[dict] = []
    hashes: list[tuple[str, int]] = []

    def observed(args, kwargs, obs):
        ticks.append({"state": args[0], "frame": obs["frame"]})

    def acted(args, kwargs, out):
        ticks[-1].update(draws=args[2], next=out[0])

    def decided(args, kwargs, out):
        ticks[-1]["controls"] = out.clone()

    taps = [trace.tapped(driver, "env_observe", after=observed),
            trace.tapped(driver, "env_act", after=acted),
            trace.tapped(owner, "policy", after=decided)]
    for mod, attr, name in HASH_SITES:
        taps.append(trace.tapped(importlib.import_module(mod), attr,
                                 before=lambda a, k, name=name: hashes.append(
                                     (name, a[0].numel() // (2 if name == "grain_texture" else 1)))))
    with contextlib.ExitStack() as stack:
        for t in taps:
            stack.enter_context(t)
        chunk()
    return ticks, hashes


def sample_ticks(ticks: int, n: int, seed: int) -> list[int]:
    """``n`` of a chunk's ticks drawn from the seed, the last always among them."""
    rng = np.random.RandomState(seed)
    pick = set(rng.choice(ticks - 1, size=min(n, ticks) - 1, replace=False).tolist()) | {ticks - 1}
    return sorted(pick)


def hash_roofline_rec(prof: dict, hashes: list, ticks: int) -> dict:
    """The sin-hash kernel's record for its roofline reader: its device ms a
    tick in the profile, and the least ms a tick from the bytes its calls of
    one tick must move."""
    k = trace.kernel_ms(prof, "hash_mode_kernel")
    if k is None or not hashes:
        return {}
    return {"hash_kernel_ms_per_tick": k[0] / prof["units"],
            "hash_least_ms_per_tick": counts.least_ms(counts.hash_bytes(hashes) / ticks)}


def finite_state(state) -> bool:
    w = state.world
    return bool(torch.isfinite(w.veh_pos).all() and torch.isfinite(w.veh_speed).all())
