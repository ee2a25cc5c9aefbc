"""Median host ms a tick of the program's ``render`` span
(``render/raster.py:render_frame``). Read from ``span_summary()`` after the
run: the window's and the check's ticks, the last 1,024 of them, none of the
profiled ones (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "render", "median_ms")
