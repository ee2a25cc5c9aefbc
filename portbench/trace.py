"""What a traced run reads from ``torch.profiler``: named ranges around the
program's module-level calls, device time and activities, the device's busy
share, the top device operations and the idle gaps by what the host was
doing. The range wrapping and the per-range device time are those of the
repository's smoke script (``profile_sim_layers``, ``profile_ops``), frozen
here so that a later change to the program cannot move them.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time

import torch

RANGE_PREFIX = "pb::"
TOP = 10  # entries of each breakdown list


@contextlib.contextmanager
def ranges(targets):
    """Wrap each ``(owner, attribute, label)`` in a profiler range
    ``pb::label`` while the block runs (an owner is a module or an object whose
    attribute the caller looks up at each call); restored afterwards."""

    def annotated(label):
        def make(f):
            def call(*args, **kwargs):
                with torch.profiler.record_function(RANGE_PREFIX + label):
                    return f(*args, **kwargs)
            return call
        return make

    with contextlib.ExitStack() as stack:
        for owner, attr, label in targets:
            stack.enter_context(patched(owner, attr, annotated(label)))
        yield


@contextlib.contextmanager
def patched(owner, attr, make):
    """``owner.attr`` replaced by ``make(original)`` while the block runs."""
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def tapped(owner, attr, before=None, after=None):
    """Call ``before(args, kwargs)`` and ``after(args, kwargs, result)`` around
    each call of ``owner.attr`` while the block runs."""

    def make(orig):
        def call(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            out = orig(*args, **kwargs)
            if after is not None:
                after(args, kwargs, out)
            return out
        return call

    return patched(owner, attr, make)


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name.strip()[:80] or "?"


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_doing(cpu, times):
    """For each of the sorted ``times``, a label of what the host ran then:
    the innermost range of the harness and the innermost operation covering
    it (one sweep over the host events, sorted by start)."""
    ranges_, ops, labels, i = [], [], [], 0
    for t in times:
        while i < len(cpu) and cpu[i].time_range.start <= t:
            e = cpu[i]
            (ranges_ if e.name.startswith(RANGE_PREFIX) else ops).append(e)
            i += 1
        for stack in (ranges_, ops):
            while stack and stack[-1].time_range.end < t:
                stack.pop()
        rng = ranges_[-1].name[len(RANGE_PREFIX):] if ranges_ else None
        op = ops[-1].name if ops else None
        labels.append("/".join(x for x in (rng, op) if x) or "outside any operation")
    return labels


def _traced(fn, activities, targets=()):
    """One synchronised call of ``fn`` under the profiler: the profiler, the
    wall, the device activities and the union of their intervals."""
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with ranges(targets), torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if _is_device(e) and e.time_range.end > e.time_range.start]
    return prof, wall, dev, _union([(e.time_range.start, e.time_range.end) for e in dev])


def profile(fn, units: int, targets=()) -> dict:
    """Two calls of ``fn`` (``units`` ticks or steps each), synchronised.

    The first is traced with device activity alone, no host operation
    recorded and no ranges: its wall (``window_s``) and the union of its
    device activity (``busy_s``, and device ms a unit). The second records
    the host's operations too, with ``targets`` in ranges: device activities
    a unit, each range's device and host ms a unit and calls, each kernel's
    device ms and count, and the breakdown (top device operations, longest
    idle gaps by host activity). Tracing slows the host's issue in both, the
    second more, so no idle share is read from the second's wall and busy
    time (``traced_window_s``, ``traced_busy_s``)."""
    from torch.profiler import ProfilerActivity

    # Without a card (the CPU tests) there is no device activity to trace.
    lean = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    _, lean_wall, lean_dev, lean_busy = _traced(fn, [lean])
    prof, wall, dev, busy = _traced(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA], targets)
    t_analysis = time.perf_counter()
    if not dev or not lean_dev:
        return {"window_s": lean_wall, "units": units}
    busy_s = sum(e - s for s, e in busy) / 1e6
    lean_busy_s = sum(e - s for s, e in lean_busy) / 1e6
    print(f"portbench: profiled {units} units twice: device only {lean_wall!r} s wall, "
          f"{lean_busy_s!r} s busy; with host operations {wall!r} s wall, {busy_s!r} s busy",
          file=sys.stderr, flush=True)
    kernels: dict[str, list] = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    range_rows = {}
    for e in prof.key_averages():
        if e.key.startswith(RANGE_PREFIX) and e.device_type == torch.autograd.DeviceType.CPU:
            range_rows[e.key[len(RANGE_PREFIX):]] = {
                "device_ms": e.device_time_total / 1e3, "host_ms": e.cpu_time_total / 1e3,
                "calls": e.count}
    cpu = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    gaps: dict[str, float] = {}
    idle = [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    for (end, nxt), label in zip(idle, _host_doing(cpu, [end for end, _ in idle])):
        gaps[label] = gaps.get(label, 0.0) + (nxt - end) / 1e6
    ops: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        ops[_short(name)] = ops.get(_short(name), 0.0) + ms / 1e3
    activities = sum(n for _, n in kernels.values())
    return {
        "units": units, "window_s": lean_wall, "busy_s": lean_busy_s,
        "traced_window_s": wall, "traced_busy_s": busy_s,
        "analysis_s": time.perf_counter() - t_analysis,
        "device_ms_per_unit": lean_busy_s * 1e3 / units,
        "activities_per_unit": activities / units,
        "ranges": range_rows,
        "kernels": {name: {"device_ms": ms, "count": n} for name, (ms, n) in kernels.items()},
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]},
    }


def kernel_ms(rec: dict, fragment: str) -> tuple[float, int] | None:
    """Device ms and launches of the profiled kernels whose name holds
    ``fragment``, or None where none ran."""
    hits = [v for k, v in rec.get("kernels", {}).items() if fragment in k]
    if not hits:
        return None
    return sum(v["device_ms"] for v in hits), sum(v["count"] for v in hits)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else "unknown"
