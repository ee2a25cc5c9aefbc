"""Seconds of set-up in the program's ``town_build`` span
(``maps/town.py:make_town01``). Read from ``span_summary()`` after the run,
which recorded set-up outside any profiler (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "town_build", "total_s")
