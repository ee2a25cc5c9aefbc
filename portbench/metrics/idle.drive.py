"""Share of the window's wall in which no device activity ran, in %: one less
the device ms a tick of the profiled part's device-only pass (``trace.profile``)
over the window's wall ms a tick. Not the profiled part's own wall: tracing
slows the host's issue there, and the device waits longer for it."""


def read(rec):
    if not rec.get("device_ms_per_unit"):
        return None
    return (1.0 - rec["device_ms_per_unit"] / rec["wall_ms_per_unit"]) * 100.0
