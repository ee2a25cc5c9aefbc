"""The row-gather kernel's share of its roofline at a group's rows, in %:
each row read and written once at the HBM rate, over the kernel's device
time a launch."""


def read(rec):
    if not rec.get("gather_kernel_ms"):
        return None
    return rec["gather_least_ms"] / rec["gather_kernel_ms"] * 100.0
