"""The sin-hash kernel's share of its roofline, in %: the least time a tick's
hash calls need (their bytes at the HBM rate; float64 operations bound them
far less) over the kernel's device time a tick."""


def read(rec):
    if not rec.get("hash_kernel_ms_per_tick"):
        return None
    return rec["hash_least_ms_per_tick"] / rec["hash_kernel_ms_per_tick"] * 100.0
