"""Host ms to issue a step: the host clock over each unit of the window's
work, stopped before its synchronise, over the steps it held."""


def read(rec):
    return rec.get("issue_ms_per_unit")
