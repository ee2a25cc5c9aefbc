"""Seconds of set-up in the program's ``route_search`` span
(``maps/routing.py:chained_route_pool``), a g++ build of the route engine
inside it included. Read from ``span_summary()`` after the run, which recorded
set-up outside any profiler (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "route_search", "total_s")
