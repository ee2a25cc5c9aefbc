"""What the readers of the program's spans share: one statistic of one span
from ``cilrs_tpu_torch.utils.profiling.span_summary()``, read in the process
that ran the cell, after its driver returned.

The program records a span only outside a profiler, so the summary holds the
set-up, the warm-up, the window and the check's chunk, and none of the
profiled ticks; a span's ring keeps its last 1,024 calls, which in a
51-second window of ``fleet128.benchtown`` are the window's last ticks and
the check's chunk. A program without spans (no ``span_summary``), or a
record that carries no run, reads as nothing.
"""

from __future__ import annotations


def stat(rec: dict, name: str, key: str, absent=None):
    """``span_summary()[name][key]``; ``absent`` where the program has spans
    but recorded none of that name; None where there is nothing to read."""
    if not rec.get("wall_ms_per_unit"):
        return None
    try:
        from cilrs_tpu_torch.utils.profiling import span_summary
    except ImportError:
        return None
    s = span_summary().get(name)
    return absent if s is None else s[key]
