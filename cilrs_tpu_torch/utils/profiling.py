"""Profiling: the program's spans and ``torch.profiler`` traces (port of
``cilrs_tpu/utils/profiling.py``, whose ``trace`` this keeps).

``span(name)`` marks a layer of the program, as a context manager or a
decorator. It is always on. Outside a profiler it takes the host clock at
entry and exit and keeps, per name, the calls, the total seconds and a ring of
the last ``RING`` durations and self times (a span's duration less its
children's), so nothing grows with a run's length; ``span_summary()`` reads
them and ``reset_spans()`` clears them. While a ``torch.profiler`` runs it
records nothing (the profiler slows the host, so its samples would be wrong)
and opens a ``record_function("cilrs::<name>")`` range instead, which puts the
span on the profiler's timeline, the device trace's clock.

``kernel_launch(name)`` puts a hand-written kernel's launch in a profiler
operation, so that a profiler links the kernel to the ranges around it.

``trace()`` wraps a block in a ``torch.profiler`` run (the CPU and, where
there is a GPU, CUDA activities) and writes a Chrome trace into ``logdir``,
where the spans show as ``cilrs::`` ranges over the device's kernels.

Spans nest on one stack: mark the thread that issues the work, not workers.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1024  # durations kept per name; a power of two
PREFIX = "cilrs::"  # the spans' profiler ranges

_clock = time.perf_counter_ns
_spans: dict = {}  # every span made, by name
# Open spans, innermost last: (start ns, the parent's children's ns so far),
# or the profiler range of a span opened while a profiler ran.
_stack: list = []
_push, _pop = _stack.append, _stack.pop
_child = 0  # ns of the innermost open span's closed children


class span:
    """A named span of the program: ``with span("render"):`` or
    ``@span("render")``. ``span(name)`` gives the one span of that name, which
    holds its record; it may be entered again while it is open (what is open
    lives on a stack), so a module keeps its spans as constants."""

    __slots__ = ("name", "label", "calls", "total_ns", "dur", "own")

    def __new__(cls, name: str):
        s = _spans.get(name)
        if s is None:
            s = _spans[name] = object.__new__(cls)
            s.name, s.label = name, PREFIX + name
            s.calls = s.total_ns = 0
            s.dur, s.own = [0] * RING, [0] * RING
        return s

    def __enter__(self):
        global _child
        # The module attribute: ``record_function`` costs microseconds even
        # with no profiler running, so it runs only under one.
        if _autograd_profiler._is_profiler_enabled:
            rng = _autograd_profiler.record_function(self.label)
            rng.__enter__()
            _push(rng)
        else:
            _push((_clock(), _child))
            _child = 0
        return self

    def __exit__(self, *exc):
        global _child
        frame = _pop()
        if frame.__class__ is not tuple:
            frame.__exit__(None, None, None)
            return False
        d = _clock() - frame[0]
        i = self.calls & (RING - 1)
        self.dur[i] = d
        self.own[i] = d - _child
        _child = frame[1] + d
        self.calls += 1
        self.total_ns += d
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return call


_NO_OPERATION = contextlib.nullcontext()


def kernel_launch(name: str):
    """The context of a hand-written kernel's launch through ctypes
    (``ops/``): while a ``torch.profiler`` runs, a profiler operation
    ``kernel::<name>``, to which the profiler links the launched kernel, and
    through it every range around it, as it links PyTorch's own kernels to
    their operators. A launch in no operation is linked to none: a
    ``record_function`` range (a span's, a benchmark's) is a user scope, and
    the profiler links only an operation's launches. Outside a profiler,
    nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast("kernel::" + name)
    return _NO_OPERATION


def profiler_running() -> bool:
    """Whether a ``torch.profiler`` runs now."""
    return _autograd_profiler._is_profiler_enabled


def span_summary() -> dict:
    """Per span name recorded outside a profiler: ``calls`` and ``total_s``
    over every call, and ``median_ms``, ``p95_ms`` (linear between ranks)
    and ``self_median_ms`` over the ring's last ``RING`` calls."""
    out = {}
    for name, s in _spans.items():
        n = min(s.calls, RING)
        if not n:
            continue
        dur = np.asarray(s.dur[:n], dtype=np.float64) / 1e6
        med, p95 = np.percentile(dur, [50, 95])
        own = np.median(np.asarray(s.own[:n], dtype=np.float64)) / 1e6
        out[name] = {"calls": s.calls, "total_s": s.total_ns / 1e9, "median_ms": float(med),
                     "p95_ms": float(p95), "self_median_ms": float(own)}
    return out


def reset_spans() -> None:
    """Forget every span's record (a span open now records its close anew)."""
    for s in _spans.values():
        s.calls = s.total_ns = 0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; writes ``logdir/trace.json`` (Chrome trace
    format, chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
