"""Seconds of set-up in the program's ``model_init`` span
(``train/state.py:create_train_state``: the model built and initialised on the
host, moved to the card, and its optimizer). Read from ``span_summary()``
after the run, which recorded set-up outside any profiler
(``portbench/spans.py``)."""

from portbench.spans import stat


def read(rec):
    return stat(rec, "model_init", "total_s")
