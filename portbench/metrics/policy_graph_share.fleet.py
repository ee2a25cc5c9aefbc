"""Share of the fleet's policy calls that replayed a CUDA graph, in %: the
program's ``policy_graph`` span's calls over its ``policy`` span's
(``agent/driver.py:fleet_rollout``), read from ``span_summary()`` after the
run: the set-up's, the window's and the check's ticks, none of the profiled
ones (``portbench/spans.py``). A program without the ``policy_graph`` span
reads 0.0."""

from portbench.spans import stat


def read(rec):
    replays = stat(rec, "policy_graph", "calls", absent=0)
    calls = stat(rec, "policy", "calls", absent=0)
    return None if replays is None or not calls else 100.0 * replays / calls
