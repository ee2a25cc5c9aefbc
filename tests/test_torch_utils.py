"""Parity of cilrs_tpu_torch.utils (logging, profiling) with cilrs_tpu.utils:
the same StepTimer report for the same phase totals, ``trace`` writing a
profile into its directory, and the log level read from CILRS_TPU_LOGLEVEL."""

import json
import logging
import os
import re

import pytest

torch = pytest.importorskip("torch")

from cilrs_tpu.utils import StepTimer as JStepTimer  # noqa: E402
from cilrs_tpu.utils import get_logger as j_get_logger  # noqa: E402
from cilrs_tpu_torch.utils import StepTimer, get_logger, trace  # noqa: E402
from cilrs_tpu_torch.utils.profiling import block_until_ready  # noqa: E402


def test_step_timer_report_matches_jax():
    got, want = StepTimer(), JStepTimer()
    for t in (got, want):
        for name, total, n in (("collect", 3.25, 13), ("train", 7.5, 40), ("eval", 0.125, 2)):
            t.totals[name], t.counts[name] = total, n
    assert got.report() == want.report()
    assert got.report().splitlines()[1].lstrip().startswith("train")


def test_step_timer_times_phases():
    timer = StepTimer()
    x = torch.arange(1000.0)
    for _ in range(3):
        with timer.phase("sum", block_on={"x": [x, (x * 2,)]}):
            y = x.sum()
    with timer.phase("plain"):
        pass
    assert timer.counts == {"sum": 3, "plain": 1} and all(v >= 0 for v in timer.totals.values())
    assert y.item() == 499500.0
    assert re.search(r"sum\s+\d+\.\d{3}s total\s+\d+\.\d{2} ms/call  x3", timer.report())
    block_until_ready([x, {"a": 1}])  # CPU tensors and non-tensors: nothing to wait for


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "profile"
    with trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert files == ["trace.json"]
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("level", ["DEBUG", "warning"])
def test_log_level_from_environment(level, monkeypatch):
    monkeypatch.setenv("CILRS_TPU_LOGLEVEL", level)
    name = f"port_test_{level}"
    got, want = get_logger(name), j_get_logger(f"jax_{name}")
    assert got.level == want.level == getattr(logging, level.upper())
    assert not got.propagate and len(got.handlers) == 1
    assert get_logger(name) is got and len(got.handlers) == 1  # configured once
    fmt = got.handlers[0].formatter
    record = logging.LogRecord(name, logging.INFO, __file__, 1, "hello %d", (7,), None)
    assert re.fullmatch(rf"\d\d:\d\d:\d\d I {name}: hello 7", fmt.format(record))


def test_default_logger_is_info(monkeypatch):
    monkeypatch.delenv("CILRS_TPU_LOGLEVEL", raising=False)
    assert get_logger("port_test_default").level == logging.INFO
