"""Helpers of the benchmark's CPU tests: a cell's run at a tiny size on the
CPU (the architecture's ``tiny`` size, a (1, 1, 1, 1) CILRS; a few envs,
ticks and frames; the kernels' plain versions), which skips the harness's
look for a card."""

from __future__ import annotations

import copy
import functools
import os
import time

import pytest
import torch

from portbench import harness

# Each driver's tiny traffic and model on the CPU.
TINY = {
    "fleet": {"traffic": {"envs": 2, "ticks": 3, "check_ticks": 2, "profile_ticks": 2}},
    "drive": {"traffic": {"ticks": 3, "check_ticks": 3, "profile_ticks": 2}},
    "train": {"traffic": {"frames": 1200}, "training": {"batch_size": 8}},
}
# Every cell the harness has files for, whether or not BENCHMARK.json runs it.
CELLS = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(harness.PB_DIR, "workloads")))


def tiny_ctx(cell: str, trace: bool = False, seed: int = 2 ** 31 + 12345) -> harness.Ctx:
    workload = copy.deepcopy(harness.load_json("workloads", cell))
    config = copy.deepcopy(harness.load_json("configs", workload["config"]))
    tiny = TINY[workload["driver"]]
    workload["traffic"].update(tiny["traffic"])
    config["model"] = harness.architecture(config["model"]).tiny(config["model"])
    config.get("training", {}).update(tiny.get("training", {}))
    return harness.Ctx(cell=cell, workload=workload, config=config, seed=seed, seconds=0.01,
                       trace=trace, device=torch.device("cpu"), t_start=time.perf_counter())


@pytest.fixture
def tiny():
    return tiny_ctx


# The configuration whose fleet the FLOP counts observe.
OBSERVED = "cilrs34.benchtown"


@functools.lru_cache(maxsize=None)
def _observation(camera: tuple):
    """A frozen drive-mode observation of one env of ``OBSERVED``'s fleet
    through the camera with the fields ``camera`` ((name, value) pairs), with
    the state and the route pool it was taken from."""
    from portbench.reference import sim as ref_sim
    from portbench.reference.frozen.agent import driver as F_driver

    sim = {**harness.load_json("configs", OBSERVED)["sim"], "camera": dict(camera)}
    ref = ref_sim.bench_start(sim, 1, 7, None, torch.device("cpu"))
    state = F_driver.make_driver_state(ref.world)
    return F_driver.env_observe(state, ref.net, ref.pool, ref.cam, mode="drive"), state, ref.pool


def counted_flops(arch, model_cfg: dict, camera: dict, train: bool) -> int:
    """FLOPs that ``torch.utils.flop_counter`` counts for one frame of
    ``camera`` through the architecture's reference model: the forward as
    ``reference_policy`` calls it on an observation, and with ``train`` that
    forward in train mode with the backward of the sum of its floating
    outputs, from the same inputs (which take no gradient)."""
    from torch.utils.flop_counter import FlopCounterMode

    obs, state, pool = _observation(tuple(sorted(camera.items())))
    model = arch.reference(model_cfg).eval()
    called = []
    hook = model.register_forward_pre_hook(lambda m, a, k: called.append((a, k)),
                                           with_kwargs=True)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        arch.reference_policy(model, obs["frame"], obs, state, pool)
    hook.remove()
    if not train:
        return fc.get_total_flops()
    args, kwargs = called[0]
    model.train()
    with FlopCounterMode(display=False) as fc:
        outs = model(*args, **kwargs)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        sum(o.sum() for o in outs if o.is_floating_point()).backward()
    return fc.get_total_flops()
