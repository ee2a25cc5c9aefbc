"""Fidelity-feature ablation: what each render and perception feature costs
inside the real drive chunk (port of ``tools/ablate_step.py``).

    python -m cilrs_tpu_torch.tools.ablate_step [--device cpu]

Runs ``bench.env_steps``'s fleet in turns, one feature off at a time, each
arm from the same initial state and draws, and reports env-steps/s and ms a
tick against the baseline chunk. The arms patch the name where its caller
looks it up, and restore it in a ``finally``, a failing arm too:

  - motion blur off: ``render.raster.motion_blur`` is the identity;
  - ground grain off: ``render.raster.grain_texture`` gives zeros of its
    shape (the JAX tool sets ``_hash2`` to 0.5, which makes the grain 0);
  - buildings off: ``render.raster.NUM_NEAR_BUILDINGS = 0``;
  - instantaneous obstacles: ``agent.perception.PREDICT_HORIZONS = (0.0,)``,
    which ``agent/driver.py`` reads at each tick;
  - ground segments K=48: ``render.raster.NUM_NEAR_SEGMENTS = 48``.

``BENCH_ENVS`` (128), ``BENCH_TICKS`` (50) and ``BENCH_REPS`` (3) are read
from the environment, as the JAX tool reads them; each arm runs one warm-up
chunk before its timed ones.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from cilrs_tpu_torch.agent import perception
from cilrs_tpu_torch.bench.env_steps import SEED, device_fields, make_bench_fleet, synchronize
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.render import raster

# (result key, printed tag, (module, name, value) patched, or None)
ARMS = (
    ("baseline", "baseline", None),
    ("no_motion_blur", "no motion blur", (raster, "motion_blur", lambda img, speed_kmh: img)),
    ("no_grain", "no ground grain",
     (raster, "grain_texture", lambda sxy: torch.zeros(sxy.shape[:-1], device=sxy.device))),
    ("no_buildings", "no buildings", (raster, "NUM_NEAR_BUILDINGS", 0)),
    ("no_predict", "instantaneous obstacles", (perception, "PREDICT_HORIZONS", (0.0,))),
    ("k48_segments", "ground segments K=48", (raster, "NUM_NEAR_SEGMENTS", 48)),
)


@contextlib.contextmanager
def patched(patch):
    """``module.name = value`` inside the block, restored on the way out."""
    if patch is None:
        yield
        return
    module, name, value = patch
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def ablate(num_envs: int, ticks: int, reps: int, device="cuda") -> dict:
    """env-steps/s and ms a tick of each arm (one warm-up chunk, then
    ``reps`` timed): {key: {env_steps_per_s, ms_per_tick}}, the baseline's
    first."""
    dev = require_cuda(device)
    base = make_bench_fleet(num_envs, ticks, dev)
    print(f"# E={num_envs} T={ticks} reps={reps} device={device_fields(dev)}", flush=True)
    results = {}
    for key, tag, patch in ARMS:
        fleet = dataclasses.replace(base, generator=torch.Generator(device=dev).manual_seed(SEED))
        with patched(patch):
            fleet.chunk()
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                fleet.chunk()
            synchronize(dev)
            dt = time.perf_counter() - t0
        results[key] = {"env_steps_per_s": num_envs * ticks * reps / dt,
                        "ms_per_tick": dt / reps / ticks * 1e3}
        print(f"{tag:28s} {results[key]['env_steps_per_s']:10,.0f} env-steps/s  "
              f"{results[key]['ms_per_tick']:7.3f} ms/tick", flush=True)
    b = results["baseline"]["env_steps_per_s"]
    print("\nfeature costs (vs baseline):")
    for key, r in results.items():
        if key != "baseline":
            r["gain_share"] = (r["env_steps_per_s"] - b) / b
            print(f"  {key:24s} {r['env_steps_per_s'] - b:+9,.0f} env-steps/s when disabled "
                  f"({r['gain_share'] * 100:+.1f}%)")
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="fidelity-feature ablation of the drive chunk "
                                            "(PyTorch/CUDA)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return ablate(int(os.environ.get("BENCH_ENVS", "128")),
                  int(os.environ.get("BENCH_TICKS", "50")),
                  int(os.environ.get("BENCH_REPS", "3")), args.device)


if __name__ == "__main__":
    main()
