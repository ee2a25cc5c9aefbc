"""Device ms a tick under the range around ``render_frame``."""


def read(rec):
    r = rec.get("ranges", {}).get("render_frame")
    return None if not r or not r["device_ms"] else r["device_ms"] / rec["units"]
