"""The check's teeth, on the CPU at a tiny size: the control (the reference
one precision down in the program's place) reads above the limits, and a run
with each fault a cell can have, planted in the program underneath the
window, comes out not correct."""

from __future__ import annotations

import pytest

from conftest import CELLS
from portbench import faults, harness

SIM_FAULTS = {"fleet": ("unchanged", "half", "altered"), "drive": ("unchanged", "altered")}
TRAIN_FAULTS = ("unchanged", "half", "altered")


def _over(readings: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not readings[k] <= lim]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, tiny):
    ctx = tiny(cell)
    out = harness.load_module("drivers", ctx.workload["driver"]).calibrate(ctx)
    assert not _over(out["program"], ctx.workload["limits"])
    assert _over(out["control"], ctx.workload["limits"])


def _fault_cases():
    for cell in CELLS:
        driver = harness.load_json("workloads", cell)["driver"]
        for f in (TRAIN_FAULTS if driver == "train" else SIM_FAULTS[driver]):
            yield cell, f


@pytest.mark.parametrize("cell,fault", list(_fault_cases()))
def test_fault_is_not_correct(cell, fault, tiny, monkeypatch):
    ctx = tiny(cell)
    driver = harness.load_module("drivers", ctx.workload["driver"])
    if ctx.workload["driver"] == "train":
        with faults.train_fault(fault):
            out = driver.run(ctx)
    else:
        # The fault goes under the check's chunk, which the window's entry runs.
        orig = driver.simrun.record_chunk

        def faulty(chunk, owner):
            with faults.sim_fault(fault, owner):
                return orig(chunk, owner)

        monkeypatch.setattr(driver.simrun, "record_chunk", faulty)
        out = driver.run(ctx)
    checked = harness.check_line(out["checked"])
    assert not all(c["ok"] for c in checked.values()), checked
