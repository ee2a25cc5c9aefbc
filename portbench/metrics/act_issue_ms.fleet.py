"""Median host ms a tick of ``agent/driver.py:env_act``'s own issue, its ``act``
span less the safety cascade, the NPCs and physics inside it: the action's
glue, the events and the metrics. Read from ``span_summary()`` after the run:
the window's and the check's ticks, the last 1,024 of them, none of the
profiled ones (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "act", "self_median_ms")
