"""The program's spans (``cilrs_tpu_torch/utils/profiling.py``) on the CPU:

 - nesting and self time under a fake clock, as a context manager, as a
   decorator and entered again while open;
 - the ring keeps the last 1,024 calls, with the median, the p95 (linear
   between ranks) and the self median over them, and calls and total over
   every call;
 - under ``torch.profiler`` nothing is recorded, and each span is a
   ``cilrs::`` range in ``key_averages()`` and in ``trace()``'s
   ``trace.json``;
 - a drive-mode ``fleet_rollout`` of 2 envs x 3 ticks records 3 calls of
   each of the tick's spans, each its parent's child, and its outputs are
   the same bit for bit with a profiler running and without;
 - the set-up's spans: the town's build, the route search, the model's init
   and a kernel build, which records a call only where a compile ran (nvcc's
   batch and the road graph's g++);
 - ``reset_spans()`` empties the store.
"""

import hashlib
import json
import os
import re
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cilrs_tpu_torch.utils import profiling  # noqa: E402
from cilrs_tpu_torch.utils.profiling import (RING, reset_spans, span, span_summary,  # noqa: E402
                                             trace)

TICK_SPANS = ("tick", "observe", "render", "policy", "act", "safety", "npc", "physics")
# Each tick span's parent: a span's duration counts toward its parent's
# children, and so comes off the parent's self time.
PARENT = {"observe": "tick", "render": "observe", "policy": "tick", "act": "tick",
          "safety": "act", "npc": "act", "physics": "act"}
E, T = 2, 3


@pytest.fixture
def clock(monkeypatch):
    """A fake clock: each reading is the next of ``clock.times`` (ns)."""

    class Clock:
        times: list = []

        def __call__(self):
            return self.times.pop(0)

    c = Clock()
    monkeypatch.setattr(profiling, "_clock", c)
    reset_spans()
    return c


def test_nesting_and_self_time(clock):
    outer, inner = span("test_outer"), span("test_inner")

    @span("test_leaf")
    def leaf():
        return "leaf"

    # outer [0, 100]: inner [10, 30] with leaf [12, 17] inside, inner [40, 45],
    # then outer entered again inside itself [50, 90].
    clock.times = [0, 10, 12, 17, 30, 40, 45, 50, 90, 100]
    with outer:
        with inner:
            assert leaf() == "leaf"
        with inner:
            pass
        with outer:
            pass
    s = span_summary()
    ms = lambda ns: pytest.approx(ns / 1e6, rel=1e-12)  # noqa: E731
    assert s["test_leaf"]["calls"] == 1 and s["test_leaf"]["median_ms"] == ms(5)
    assert s["test_inner"]["calls"] == 2 and s["test_inner"]["total_s"] == ms(25e-3)
    assert s["test_inner"]["median_ms"] == ms(12.5)
    assert s["test_inner"]["self_median_ms"] == ms(((20 - 5) + 5) / 2)
    assert s["test_outer"]["calls"] == 2 and s["test_outer"]["total_s"] == ms(140e-3)
    # The outer call's self: 100 less its children's 20 + 5 + 40.
    assert sorted(profiling._spans["test_outer"].own[:2]) == [35, 40]
    assert not profiling._stack


def test_span_closes_on_an_exception(clock):
    clock.times = [0, 7]
    with pytest.raises(ValueError):
        with span("test_raises"):
            raise ValueError("inside")
    assert span_summary()["test_raises"]["total_s"] == pytest.approx(7e-9, rel=1e-12)
    assert not profiling._stack


def test_one_span_a_name():
    assert span("test_same") is span("test_same")
    assert span("test_same").label == "cilrs::test_same"


@pytest.mark.parametrize("n", [1, 2, RING - 1, RING, RING + 1, 3 * RING + 5])
def test_ring_keeps_the_last_calls(clock, n):
    s = span("test_ring")
    durations_ms = [(i * 7919) % 1000 + 1 for i in range(n)]  # 1-1000 ms, shuffled
    for d in durations_ms:
        clock.times = [0, d * 1_000_000]
        with s:
            pass
    got = span_summary()["test_ring"]
    kept = sorted(durations_ms[-RING:])

    def rank(q):  # linear between ranks
        pos = q * (len(kept) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(kept) - 1)
        return kept[lo] + (pos - lo) * (kept[hi] - kept[lo])

    assert got["calls"] == n
    assert got["total_s"] == pytest.approx(sum(durations_ms) / 1e3, rel=1e-12)
    assert got["median_ms"] == pytest.approx(rank(0.5), rel=1e-12)
    assert got["p95_ms"] == pytest.approx(rank(0.95), rel=1e-12)
    assert got["self_median_ms"] == got["median_ms"]


def test_reset_spans_empties_the_store(clock):
    clock.times = [0, 5, 10, 20]
    with span("test_reset"):
        pass
    assert "test_reset" in span_summary()
    with span("test_reset_open"):
        reset_spans()
    assert span_summary() == {"test_reset_open": span_summary()["test_reset_open"]}
    reset_spans()
    assert span_summary() == {}


def test_under_a_profiler_spans_record_nothing_and_open_ranges():
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test_prof_outer"):
            with span("test_prof_inner"):
                torch.ones(8) + 1
    assert span_summary() == {} and not profiling._stack
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys["cilrs::test_prof_outer"] == 1 and keys["cilrs::test_prof_inner"] == 1
    with span("test_prof_after"):
        pass
    assert set(span_summary()) == {"test_prof_after"}


def test_kernel_launch_is_an_operation_under_a_profiler_only():
    """A kernel's launch context is a ``kernel::`` operation inside the ranges
    around it while a profiler runs, and nothing outside one."""
    assert profiling.kernel_launch("test_kernel") is profiling._NO_OPERATION
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test_launch_outer"):
            with profiling.kernel_launch("test_kernel"):
                torch.ones(8) + 1
    events = {e.name: e for e in prof.events()}
    op = events["kernel::test_kernel"]
    assert op.cpu_parent is not None and op.cpu_parent.name == "cilrs::test_launch_outer"
    assert any(c.name == "aten::add" for c in op.cpu_children)
    assert profiling.kernel_launch("test_kernel") is profiling._NO_OPERATION


def test_trace_writes_the_spans_into_a_chrome_trace(tmp_path):
    logdir = tmp_path / "profile"
    with trace(str(logdir)):
        with span("test_traced"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(logdir) == ["trace.json"]
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert "cilrs::test_traced" in {e.get("name") for e in events}


@pytest.fixture(scope="module")
def rollouts():
    """One drive-mode chunk of E envs x T ticks on the mini town with a
    (1, 1, 1, 1) CILRS, twice from the same start: without a profiler (the
    spans' summary right after it) and under one."""
    from cilrs_tpu_torch.agent.driver import fleet_rollout, make_driver_state, model_policy
    from cilrs_tpu_torch.agent.npc import draw_pedestrians
    from cilrs_tpu_torch.agent.scenario import spawn_world
    from cilrs_tpu_torch.config import ModelConfig, TrainConfig, load_weather_table
    from cilrs_tpu_torch.core.convert import pool_from_arrays, world_from_arrays
    from cilrs_tpu_torch.core.state import default_vehicle_params
    from cilrs_tpu_torch.maps.routing import chained_route_pool
    from cilrs_tpu_torch.maps.town import make_mini_town
    from cilrs_tpu_torch.train.state import create_train_state

    reset_spans()
    net = make_mini_town()
    rng = np.random.RandomState(3)
    pool = chained_route_pool(net, rng, num_routes=2)
    world = spawn_world(net, 4, 2, rng)
    worlds = world_from_arrays([world] * E, "cpu").replace(weather_idx=torch.arange(E))
    cfg = TrainConfig(model=ModelConfig(dropout=0.0, stage_sizes=(1, 1, 1, 1)))
    policy = model_policy(create_train_state(cfg, 0, device="cpu").model.eval())
    setup = span_summary()
    args = (net, pool_from_arrays([pool] * E), load_weather_table(device="cpu"),
            default_vehicle_params("cpu"))
    draws = draw_pedestrians(torch.Generator().manual_seed(5), T, E, 2, "cpu")

    def chunk():
        return fleet_rollout(make_driver_state(worlds), T, *args, draws, mode="drive",
                             policy=policy, want_frames=False)

    reset_spans()
    plain = chunk()
    summary = span_summary()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiled = chunk()
    return {"setup": setup, "summary": summary, "plain": plain, "profiled": profiled,
            "profiled_summary": span_summary(),
            "ranges": {e.key: e.count for e in prof.key_averages()}}


@pytest.mark.parametrize("name", TICK_SPANS)
def test_rollout_records_each_tick_span(rollouts, name):
    s = rollouts["summary"][name]
    assert s["calls"] == T
    assert 0 < s["self_median_ms"] <= s["median_ms"] <= s["p95_ms"]
    if name in PARENT:
        parent = rollouts["summary"][PARENT[name]]
        assert s["total_s"] < parent["total_s"]
    assert rollouts["ranges"][f"cilrs::{name}"] == T


def test_tick_spans_cover_the_tick(rollouts):
    s = rollouts["summary"]
    children = s["observe"]["total_s"] + s["policy"]["total_s"] + s["act"]["total_s"]
    assert children < s["tick"]["total_s"] < children * 1.05
    assert set(rollouts["profiled_summary"]) == set(TICK_SPANS)  # nothing added under it
    assert all(v["calls"] == T for v in rollouts["profiled_summary"].values())


def test_rollout_is_the_same_under_a_profiler(rollouts):
    from cilrs_tpu_torch.core.state import tree_map

    (s1, o1), (s2, o2) = rollouts["plain"], rollouts["profiled"]
    assert list(o1) == list(o2)
    for k in o1:
        assert o1[k].dtype == o2[k].dtype and torch.equal(o1[k], o2[k]), k
    same = []
    tree_map(lambda a, b: same.append(a.dtype == b.dtype and torch.equal(a, b)), s1, s2)
    assert len(same) > 20 and all(same)


@pytest.mark.parametrize("name", ["town_build", "route_search", "model_init"])
def test_set_up_spans(rollouts, name):
    s = rollouts["setup"][name]
    assert s["calls"] == 1 and s["total_s"] > 0
    assert s["median_ms"] == pytest.approx(s["total_s"] * 1e3, rel=1e-12)


def test_kernel_build_span_counts_the_compiles_run(tmp_path, monkeypatch):
    from cilrs_tpu_torch.ops import build

    fake = tmp_path / "nvcc"  # writes the file after -o
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    reset_spans()
    assert set(build.build(["gather_rows", "hash_sinf"])) == {"gather_rows", "hash_sinf"}
    assert span_summary()["kernel_build"]["calls"] == 1  # one batch, both compiles
    assert build.build(["gather_rows", "hash_sinf"]) == {}  # built: nothing compiles
    assert span_summary()["kernel_build"]["calls"] == 1
    os.remove(build.library_path("hash_sinf"))
    assert set(build.build(["gather_rows", "hash_sinf"])) == {"hash_sinf"}
    assert span_summary()["kernel_build"]["calls"] == 2


def test_road_graph_compile_is_one_kernel_build(tmp_path, monkeypatch):
    """The road graph's g++ build goes through ``ops/build.py``: its library
    keeps its name (a digest of the source and the flags) and its compile is
    one ``kernel_build`` call, none once built."""
    from cilrs_tpu_torch.maps import native_graph
    from cilrs_tpu_torch.ops import build

    fake = tmp_path / "bin" / "g++"  # writes the file after -o
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with open(native_graph.SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + b"-O2 -std=c++17 -shared -fPIC").hexdigest()[:16]
    want = tmp_path / "_build" / f"libroadgraph_{digest}.so"
    native_graph.library.cache_clear()
    reset_spans()
    with pytest.raises(OSError, match=re.escape(str(want))):  # the fake's file loads as nothing
        native_graph.library()
    assert want.read_text() == "built\n"
    assert span_summary()["kernel_build"]["calls"] == 1
    with pytest.raises(OSError, match=re.escape(str(want))):
        native_graph.library()
    assert span_summary()["kernel_build"]["calls"] == 1
