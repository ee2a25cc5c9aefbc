"""Each driver runs one tiny window on the CPU through the rest of a run, and
the run comes out correct; the traced run's readers return a number or
nothing."""

from __future__ import annotations

import math

import pytest

from conftest import CELLS
from portbench import harness


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_window(cell, trace, tiny):
    ctx = tiny(cell, trace=trace)
    out = harness.load_module("drivers", ctx.workload["driver"]).run(ctx)
    assert out["attempted"] >= 1 and out["failed"] == 0
    checked = harness.check_line(out["checked"])
    assert set(checked) == set(ctx.workload["limits"])
    assert all(c["ok"] for c in checked.values()), checked
    assert out["e2e"] and all(v > 0 for v in out["e2e"].values())
    assert ctx.setup_s > 0
    for m in harness.benchmark()["per_layer"]:
        v = harness.load_module("metrics", m["name"]).read(out["rec"])
        assert v is None or math.isfinite(v)
