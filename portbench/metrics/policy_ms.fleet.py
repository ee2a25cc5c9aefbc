"""Device ms a tick under the range around the fleet's policy (the CILRS forward)."""


def read(rec):
    r = rec.get("ranges", {}).get("policy")
    return None if not r or not r["device_ms"] else r["device_ms"] / rec["units"]
