"""Device activities (kernels, copies, sets) a step in the profiled part."""


def read(rec):
    return rec.get("activities_per_unit")
