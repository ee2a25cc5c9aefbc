"""Seconds of set-up spent compiling, by the program's ``kernel_build`` spans
(``ops/build.py:build``'s nvcc batch, ``maps/native_graph.py:library``'s g++):
0.0 where everything was built already. Read from ``span_summary()`` after the
run, which recorded set-up outside any profiler (``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "kernel_build", "total_s", absent=0.0)
