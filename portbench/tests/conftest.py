"""Helpers of the benchmark's CPU tests: a cell's run at a tiny size on the
CPU (a (1, 1, 1, 1) CILRS, a few envs, ticks and frames, the kernels' plain
versions), which skips the harness's look for a card."""

from __future__ import annotations

import copy
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
    config["model"]["stage_sizes"] = [1, 1, 1, 1]
    config.get("training", {}).update(tiny.get("training", {}))
    return harness.Ctx(cell=cell, workload=workload, config=config, seed=seed, seconds=0.01,
                       trace=trace, device=torch.device("cpu"), t_start=time.perf_counter())


@pytest.fixture
def tiny():
    return tiny_ctx
