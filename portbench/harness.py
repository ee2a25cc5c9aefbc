"""The harness's shared parts: cells, configurations, drivers and per-layer
readers found by name; the run's context and clocks; the result line.

A cell is ``workloads/<cell>.json`` (its configuration, its driver, its
traffic parameters, its limits and its ``why``); a configuration is
``configs/<config>.json``; a driver is ``drivers/<driver>.py`` with a
``run(ctx)``; a policy architecture is ``policies/<arch>.py``, named by a
configuration's ``model.arch``; a per-layer metric is ``metrics/<metric>.py``
with a ``read(rec)`` that returns a number or None. Later cells,
configurations, architectures and metrics are new files, found by the names
in ``BENCHMARK.json`` and in the configurations.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

PB_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB_DIR)  # the checkout
# Top-level modules the benchmark's process may not hold: JAX and the JAX
# package. Compared whole: ``cilrs_tpu_torch`` is not ``cilrs_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cilrs_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(PB_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(PB_DIR, kind, f"{name}.py")
    full = f"portbench.{kind}.{name}"
    if full not in sys.modules:
        spec = importlib.util.spec_from_file_location(full, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
    return sys.modules[full]


def architecture(model_cfg: dict):
    """The module ``policies/<arch>.py`` of a configuration's ``model.arch``:
    its ``reference``, ``program``, ``reference_policy``, ``forward_flops``,
    ``train_flops`` and ``tiny``, and optionally ``carry``
    (``policies/cilrs.py`` says what each is)."""
    arch = model_cfg.get("arch")
    if not isinstance(arch, str) or not os.path.isfile(os.path.join(PB_DIR, "policies",
                                                                    f"{arch}.py")):
        raise ValueError(f"the configuration's model.arch {arch!r} names no "
                         f"portbench/policies/<arch>.py")
    return load_module("policies", arch)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, key: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # the process's start, on time.perf_counter
    t_open: float | None = None  # the window's opening

    def seed_for(self, salt: int, bits: int = 31) -> int:
        """A seed for one consumer (a RandomState, a generator) from --seed,
        which may exceed 32 bits."""
        return (self.seed * 1_000_003 + salt * 7_919) % (1 << bits)

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def open_window(self):
        self.t_open = time.perf_counter()

    @property
    def setup_s(self) -> float:
        return self.t_open - self.t_start


def sync(dev):
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def window(ctx: Ctx, chunk, end=None) -> dict:
    """The measured window: ``chunk()`` again and again (and ``end`` on its
    result, timed apart), each followed by a synchronise, until
    ``ctx.seconds`` have passed since the window opened. Returns the chunks
    run, the wall, the host's time to issue the chunks and the time in
    ``end``."""
    ctx.open_window()
    issue = end_s = 0.0
    n = 0
    while True:
        t0 = time.perf_counter()
        out = chunk()
        t1 = time.perf_counter()
        if end is not None:
            end(out)
        sync(ctx.device)
        issue += t1 - t0
        end_s += time.perf_counter() - t1
        n += 1
        if time.perf_counter() - ctx.t_open >= ctx.seconds:
            break
    return {"chunks": n, "wall_s": time.perf_counter() - ctx.t_open, "issue_s": issue,
            "end_s": end_s}


def check_line(checked: dict) -> dict:
    """Each compared number with its limit; ``ok`` where it is within."""
    return {k: {"value": v, "limit": lim, "ok": bool(math.isfinite(v) and v <= lim)}
            for k, (v, lim) in checked.items()}

