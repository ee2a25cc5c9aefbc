"""Share of the fleet's safety-cascade calls that replayed a CUDA graph, in
%: the program's ``safety_graph`` span's calls over its ``safety`` span's
(``agent/controller.py:safety_controller``), read from ``span_summary()``
after the run: the set-up's, the window's and the check's ticks, none of the
profiled ones (``portbench/spans.py``). A program without the
``safety_graph`` span reads 0.0."""

from portbench.spans import stat


def read(rec):
    replays = stat(rec, "safety_graph", "calls", absent=0)
    calls = stat(rec, "safety", "calls", absent=0)
    return None if replays is None or not calls else 100.0 * replays / calls
