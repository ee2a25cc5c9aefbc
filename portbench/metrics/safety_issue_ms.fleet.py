"""Median host ms a tick of the program's ``safety`` span
(``agent/controller.py:safety_controller``). Read from ``span_summary()``
after the run: the window's and the check's ticks, the last 1,024 of them,
none of the profiled ones (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "safety", "median_ms")
