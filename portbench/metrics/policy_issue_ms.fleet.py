"""Median host ms a tick of the program's ``policy`` span: the frame's normalize
and the policy's call in ``agent/driver.py:fleet_rollout``, under
``inference_mode``. Read from ``span_summary()`` after the run: the window's
and the check's ticks, the last 1,024 of them, none of the profiled ones
(``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "policy", "median_ms")
