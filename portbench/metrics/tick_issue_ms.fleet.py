"""Median host ms a tick issues in, by the program's ``tick`` span (the loop body
of ``agent/driver.py:fleet_rollout``). Read from ``span_summary()`` after the
run: the window's and the check's ticks, the last 1,024 of them, none of the
profiled ones (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "tick", "median_ms")
