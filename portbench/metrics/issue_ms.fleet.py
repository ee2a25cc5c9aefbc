"""Host ms to issue a tick: the host clock over each unit of the window's
work, stopped before its synchronise, over the ticks it held."""


def read(rec):
    return rec.get("issue_ms_per_unit")
