"""The benchmark's files: every configuration, cell, driver and per-layer
metric that BENCHMARK.json names, and every configuration's policy
architecture, is found and loaded by name, and the names, units and keys keep
to the benchmark's contract."""

from __future__ import annotations

import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # A full check with 24 cells fits its limit at this run length.
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[kind] <= set(e) <= ENTRY_KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("unit",):
            if key in e:
                assert UNIT.match(e[key]), e[key]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "better" in e:
            assert e["better"] in ("lower", "higher")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    assert harness.load_json("configs", config)["name"] == config
    assert all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == config for w in BENCH["workloads"])


ARCH_FUNCTIONS = ("reference", "program", "reference_policy", "forward_flops", "train_flops",
                  "tiny")
CONFIG_FILES = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(harness.PB_DIR,
                                                                         "configs")))


@pytest.mark.parametrize("config", CONFIG_FILES)
def test_config_arch_found_by_name(config):
    model_cfg = harness.load_json("configs", config)["model"]
    arch = harness.architecture(model_cfg)
    assert arch.__file__ == os.path.join(harness.PB_DIR, "policies", f"{model_cfg['arch']}.py")
    assert NAME.match(model_cfg["arch"])
    for name in ARCH_FUNCTIONS:
        assert callable(getattr(arch, name)) and getattr(arch, name).__doc__, name


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    workload = harness.load_json("workloads", cell)
    assert workload["config"] == entry["config"] and workload["why"] == entry["why"]
    assert NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    driver = harness.load_module("drivers", workload["driver"])
    assert callable(driver.run) and callable(driver.calibrate)
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    assert set(workload["limits"]) and all(v >= 0 for v in workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    reader = harness.load_module("metrics", metric)
    assert reader.read({}) is None  # nothing to read: nothing returned


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_files_named_from_names():
    for root, _, files in os.walk(harness.PB_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
