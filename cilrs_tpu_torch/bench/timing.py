"""Timing on an NVIDIA GPU, for ``chip_smoke.py`` and the kernel A/B scripts.

Device times come from CUDA events around many launches queued back to back;
host times from a host clock around the enqueue alone. Nothing here runs on a
machine without CUDA.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def copy_bound_ms(nbytes: int) -> float:
    """Least time to read ``nbytes`` and write ``nbytes`` through HBM."""
    return 2 * nbytes / HBM_BYTES_PER_S * 1e3


def median_ms(fn, reps: int = 20, rounds: int = 7, warmup: int = 3) -> float:
    """Device time of one call of fn: CUDA events around ``reps`` calls queued
    back to back (so the host's launch overhead hides behind the device's
    work, as on the path), divided by ``reps``; the median of ``rounds``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call))


def queued_ms(fn, reps: int = 20, rounds: int = 7, warmup: int = 3) -> float:
    """Device time of one call of fn when the host issues calls slower than
    the card runs them (a kernel of a few microseconds): the stream first
    sleeps on the card for twice the host's time to issue ``reps`` calls,
    so every call is queued before the first runs and the events time them
    back to back on the device alone. The median of ``rounds``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # The card's sleep rate, cycles a millisecond, from one timed sleep.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    cycles = int(2 * issue_ms * 1_000_000 / start.elapsed_time(end)) + 1
    per_call = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call))


def host_us_per_call(fn, calls: int = 1000, batch: int = 200) -> float:
    """Host time to issue one call of fn, in microseconds: a host clock over
    ``calls`` calls queued back to back. The clock stops before the
    synchronise that follows every ``batch`` calls, which keeps the launch
    queue from filling (a full queue would stall the host on the device)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // batch * batch) * 1e6


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def profiled_device_time(fn, names: bool = False) -> tuple:
    """One call of fn under torch.profiler, synchronised: the device ms of
    the kernels and copies it ran, summed, and their count, from the trace's
    device events; with ``names``, also the set of their names (without a
    kernel's parameters). Warm fn up first (cuDNN's algorithms, built
    kernels, cached constants)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.time_range.end > e.time_range.start]
    out = (sum(e.time_range.end - e.time_range.start for e in device) / 1e3, len(device))
    if names:
        return (*out, {e.name.split("(")[0].removeprefix("void ").strip() for e in device})
    return out
