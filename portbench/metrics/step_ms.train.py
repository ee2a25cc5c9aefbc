"""Device ms a train step: the profiled group's device activity over its steps."""


def read(rec):
    return rec.get("device_ms_per_unit")
