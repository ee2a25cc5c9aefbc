"""Parity of cilrs_tpu_torch.utils (logging, profiling) with cilrs_tpu.utils:
``trace`` writing a profile into its directory, and the log level read from
CILRS_TPU_LOGLEVEL (the spans: tests/test_torch_profiling.py)."""

import json
import logging
import os
import re

import pytest

torch = pytest.importorskip("torch")

from cilrs_tpu.utils import get_logger as j_get_logger  # noqa: E402
from cilrs_tpu_torch.utils import get_logger, trace  # noqa: E402


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
