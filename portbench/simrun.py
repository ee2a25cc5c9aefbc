"""What the fleet and drive drivers share: the program's policy of the
configuration's architecture with the run's weights and the reader of what it
carries from tick to tick, the configuration's camera, the tick's layer
ranges, the hash calls of a tick, and the record of a chunk that the
reference follows (``reference/sim.py``)."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import numpy as np
import torch

from portbench import counts, harness, trace
from portbench.weights import seeded_state_dict

# The attribute of a fleet or drive run that holds the reader of its
# program policy's carry (``keep_carry``).
CARRY_ATTR = "portbench_carry"

# The sin-hash entry points as their callers look them up: (module path,
# attribute, entry point).
HASH_SITES = (("cilrs_tpu_torch.render.weather", "hash01", "hash01"),
              ("cilrs_tpu_torch.render.raster", "grain_texture", "grain_texture"),
              ("cilrs_tpu_torch.agent.driver", "reverse_steer", "reverse_steer"))


def program_policy(ctx, fp32: bool = False):
    """The run's weights, made from the seed for the configuration's
    architecture, and the program's fleet policy holding them
    (``policies/<arch>.py:program``; ``fp32`` is its witness in float32,
    never a run). Returns (policy, weights)."""
    model_cfg = ctx.config["model"]
    sd = seeded_state_dict(model_cfg, ctx.seed_for(2), ctx.device)
    _, policy = harness.architecture(model_cfg).program(model_cfg, sd, ctx.device, fp32)
    return policy, sd


def keep_carry(owner, ctx, policy) -> None:
    """Keep on ``owner`` (a fleet or drive run) the reader of the carry of
    ``policy``, the object that ``policies/<arch>.py:program`` returned: its
    architecture's ``carry(policy)``, a dict of tensors [E, ...] that the
    policy updates in place, or None. It reads ``policy`` itself, never
    whatever wraps ``owner.policy`` (the harness's ranges and taps, a fault).
    An architecture without the hook carries nothing, and nothing is kept."""
    hook = getattr(harness.architecture(ctx.config["model"]), "carry", None)
    if hook is not None:
        setattr(owner, CARRY_ATTR, lambda: hook(policy))


def carry_reader(owner):
    """The reader that ``keep_carry`` kept on ``owner``, or None."""
    return getattr(owner, CARRY_ATTR, None)


def cloned(carry: dict | None) -> dict | None:
    """A copy of a carry, each tensor cloned."""
    return None if carry is None else {k: v.clone() for k, v in carry.items()}


def camera(sim: dict):
    """The program's ``CameraSpec`` of the configuration's ``sim.camera``
    (fields by name, the rest its defaults)."""
    from cilrs_tpu_torch.render.camera import CameraSpec

    return CameraSpec(**sim["camera"])


def set_camera(owner, cam) -> None:
    """Give the program's fleet or drive run the camera ``cam``: its ``cam``
    field where its class has one. A class without one renders the default
    camera, so it takes no other."""
    from cilrs_tpu_torch.render.raster import CAMERA

    if any(f.name == "cam" for f in dataclasses.fields(owner)):
        owner.cam = cam
    elif cam != CAMERA:
        raise ValueError(f"the program's {type(owner).__name__} has no cam field and renders "
                         f"{CAMERA}; the configuration asks for {cam}")


def mfu_pct(ctx, units_per_s: float) -> float:
    """The share of the card's bf16 peak of the policy's forward FLOPs
    (``policies/<arch>.py:forward_flops`` at the configuration's widths and
    camera) at ``units_per_s`` frames a second, in %."""
    model_cfg = ctx.config["model"]
    flops = harness.architecture(model_cfg).forward_flops(model_cfg, camera(ctx.config["sim"]))
    return units_per_s * flops / counts.PEAK_BF16_FLOPS * 100


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
    the sin-hash calls it made as (entry point, elements). Where ``owner``'s
    policy carries state (``keep_carry``), each tick also holds its ``carry``
    as it stood just before the policy's call and ``carry_next`` just after.
    The taps wrap ``owner.policy`` as it is when the chunk starts, a fault
    included, so the carry is read outside what a fault does to it."""
    from cilrs_tpu_torch.agent import driver

    ticks: list[dict] = []
    hashes: list[tuple[str, int]] = []
    carry = carry_reader(owner)

    def observed(args, kwargs, obs):
        ticks.append({"state": args[0], "frame": obs["frame"]})

    def acted(args, kwargs, out):
        ticks[-1].update(draws=args[2], next=out[0])

    def deciding(args, kwargs):
        ticks[-1]["carry"] = cloned(carry())

    def decided(args, kwargs, out):
        ticks[-1]["controls"] = out.clone()
        if carry is not None:
            ticks[-1]["carry_next"] = cloned(carry())

    taps = [trace.tapped(driver, "env_observe", after=observed),
            trace.tapped(driver, "env_act", after=acted),
            trace.tapped(owner, "policy", before=deciding if carry else None, after=decided)]
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
