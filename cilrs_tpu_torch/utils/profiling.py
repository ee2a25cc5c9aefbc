"""Profiling: torch.profiler traces and phase timing (port of
``cilrs_tpu/utils/profiling.py``).

``trace()`` wraps a block in a ``torch.profiler`` run (the CPU and, where
there is a GPU, CUDA activities) and writes a Chrome trace into ``logdir``;
``StepTimer`` accumulates per-phase wall times, synchronizing the device of
the tensors it is given so that the numbers mean what they say.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the CUDA devices that hold any tensor of ``tree`` (a tensor,
    or dicts, lists and tuples of them) to finish their queued work."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


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


class StepTimer:
    """Accumulates per-phase timings; ``block_on`` syncs its devices first."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase timings:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name:24s} {total:8.3f}s total  {total / max(n, 1) * 1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)
