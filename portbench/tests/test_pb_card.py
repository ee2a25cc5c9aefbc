"""On the card, at the cell's own size: the program reads within every limit
and the control above one, on one seed. Skips without a CUDA device."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import CELLS
from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's size runs on the card")
    workload = harness.load_json("workloads", cell)
    ctx = harness.Ctx(cell=cell, workload=workload,
                      config=harness.load_json("configs", workload["config"]), seed=2 ** 31 + 99,
                      seconds=0.0, trace=False, device=torch.device("cuda"),
                      t_start=time.perf_counter())
    out = harness.load_module("drivers", workload["driver"]).calibrate(ctx)
    lim = workload["limits"]
    assert all(out["program"][k] <= v for k, v in lim.items()), out
    assert any(not out["control"][k] <= v for k, v in lim.items()), out
