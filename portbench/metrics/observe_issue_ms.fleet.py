"""Median host ms a tick of ``agent/driver.py:env_observe``'s own issue, its
``observe`` span less the render inside it: the route, perception and the
lights. Read from ``span_summary()`` after the run: the window's and the
check's ticks, the last 1,024 of them, none of the profiled ones
(``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "observe", "self_median_ms")
