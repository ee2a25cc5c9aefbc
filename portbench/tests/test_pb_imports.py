"""What a run loads: nothing of JAX or the JAX package (top-level names
compared whole), and a reference that imports nothing of the program."""

from __future__ import annotations

import subprocess
import sys

from portbench import harness

LOAD_A_RUN = """
import sys, torch
from portbench import harness
import portbench.run, portbench.calibrate
bench = harness.benchmark()
for w in bench["workloads"]:
    harness.load_module("drivers", harness.load_json("workloads", w["name"])["driver"])
for m in bench["per_layer"]:
    harness.load_module("metrics", m["name"])
for c in bench["configs"]:
    harness.architecture(harness.load_json("configs", c["name"])["model"])
import cilrs_tpu_torch.bench.env_steps, cilrs_tpu_torch.cli.drive, cilrs_tpu_torch.train.loop
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
LOAD_THE_REFERENCE = """
import os, sys
import portbench.reference.sim, portbench.reference.train, portbench.weights, portbench.counts
from portbench import harness
for f in os.listdir(os.path.join(harness.PB_DIR, "configs")):
    model_cfg = harness.load_json("configs", f[:-len(".json")])["model"]
    harness.architecture(model_cfg).reference(model_cfg)
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] == "cilrs_tpu_torch")))
"""


def _run(code: str) -> str:
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return (res.stdout.strip().splitlines() or [""])[-1]


def test_a_run_loads_no_jax():
    tops = _run(LOAD_A_RUN).split(",")
    assert "cilrs_tpu_torch" in tops
    assert harness.forbidden_modules(tops) == []


def test_the_check_compares_names_whole():
    assert harness.forbidden_modules(["cilrs_tpu_torch.agent", "jaxtyping"]) == []
    assert harness.forbidden_modules(["cilrs_tpu.models", "jax.numpy"]) == ["cilrs_tpu", "jax"]


def test_the_reference_imports_nothing_of_the_program():
    assert _run(LOAD_THE_REFERENCE) == ""
