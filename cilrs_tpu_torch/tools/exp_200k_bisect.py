"""Bisect the 200k-frame training collapse (port of ``tools/exp_200k_bisect.py``).

Two hypotheses for a collapse that shows at 200k frames and not at 150k:

  (a) data content: frames from LATE sim time (each env runs about 12.5k
      ticks at 200k against 9.4k at 150k) carry degraded teacher turn labels;
  (b) a training-side size effect: something about the bigger table or split
      breaks past 150k.

ONE collection, then two trainings on the SAME table with the SAME val rows:
  arm subset: a random train subset of the 150k run's size (max_train_frames);
  arm full:   the full train split.
subset sick -> (a); subset healthy and full sick -> (b). Each arm's best
weights are scored on the val rows. A host-side label analysis by tick band
tests (a) from the labels before any training. The tool sets
``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless the caller set it, for the duration
of ``main``.

    python -m cilrs_tpu_torch.tools.exp_200k_bisect [--frames 200000 --subset 127500]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
from cilrs_tpu_torch.tools.arms import best_model, report_rows, with_epochs
from cilrs_tpu_torch.tools.exp_checksum import allow_big_table
from cilrs_tpu_torch.train.loop import train


def label_analysis(labels: dict, band: int = 1000) -> dict:
    """Per-tick-band teacher-label stats, focused on turn quality."""
    tick = labels["tick"]
    cmd = labels["command"]
    steer = labels["controls"][:, 0]
    speed = labels["speed_kmh"]
    obst = labels["obstacle_dist"]
    turn = (cmd == 1) | (cmd == 2)
    bands = []
    for lo in range(0, int(tick.max()) + 1, band):
        m = (tick >= lo) & (tick < lo + band)
        mt = m & turn
        n, nt = int(m.sum()), int(mt.sum())
        if n == 0:
            continue
        row = {
            "tick_lo": lo,
            "frames": n,
            "turn_frames": nt,
            "turn_frac": round(nt / n, 4),
            "mean_speed_kmh": round(float(speed[m].mean()), 2),
            "obst_lt12_frac": round(float((obst[m] < 12.0).mean()), 4),
        }
        if nt:
            a = np.abs(steer[mt])
            row.update({
                "turn_abs_steer_mean": round(float(a.mean()), 4),
                "turn_abs_steer_p50": round(float(np.median(a)), 4),
                "turn_flat_frac": round(float((a < 0.05).mean()), 4),
                "turn_obst_lt12_frac": round(float((obst[mt] < 12.0).mean()), 4),
                "turn_mean_speed_kmh": round(float(speed[mt].mean()), 2),
            })
        bands.append(row)
    return {"band": band, "bands": bands}


def print_bands(analysis: dict):
    cols = ("tick_lo", "frames", "turn_frac", "turn_abs_steer_mean",
            "turn_abs_steer_p50", "turn_flat_frac", "turn_obst_lt12_frac",
            "turn_mean_speed_kmh", "mean_speed_kmh")
    print("  " + "  ".join(f"{c:>20}" for c in cols))
    for row in analysis["bands"]:
        print("  " + "  ".join(f"{row.get(c, ''):>20}" for c in cols))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/r4a")
    p.add_argument("--frames", type=int, default=200_000)
    p.add_argument("--subset", type=int, default=127_500,
                   help="arm-S train-split cap (= 0.85 * 150k, the r3m size)")
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--vehicles", type=int, default=12)
    p.add_argument("--walkers", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--arms", nargs="*", default=["subset", "full"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    with allow_big_table():
        print(f"=== collect {args.frames} frames (seed {args.seed}) ===", flush=True)
        t0 = time.time()
        table, labels, _ = collect_resident(
            build_map("town01"), args.frames, num_envs=args.envs, num_vehicles=args.vehicles,
            num_pedestrians=args.walkers, weather_idx=None, seed=args.seed,
            output_dir=os.path.join(args.workdir, "session_resident"), device=dev)
        print(f"collect: {time.time() - t0:.0f}s", flush=True)

        print("\n=== label analysis by tick band ===", flush=True)
        analysis = label_analysis(labels)
        print_bands(analysis)
        with open(os.path.join(args.workdir, "label_analysis.json"), "w") as f:
            json.dump(analysis, f, indent=2)
        # Keep raw labels for deeper host-side digging without a re-collect.
        np.savez_compressed(os.path.join(args.workdir, "labels.npz"), **labels)
        res = {"analysis": analysis, "arms": {}}
        if args.skip_train:
            return res

        cfg = with_epochs(load_train_config(), args.epochs)
        ds = labels_dataset(labels)
        for name in args.arms:
            cap = args.subset if name == "subset" else None
            print(f"\n=== train arm {name} (cap={cap}) ===", flush=True)
            t0 = time.time()
            ckpt_dir = os.path.join(args.workdir, f"ckpt_{name}")
            out = train(ds, cfg, ckpt_dir=ckpt_dir, resident=table, max_train_frames=cap,
                        device=dev)
            wall = time.time() - t0
            print(f"arm {name}: best val {out['best_val_loss']:.4f} in {wall:.0f}s", flush=True)
            print(f"arm {name} on the val rows", end="")
            rep = report_rows(best_model(cfg, ckpt_dir, dev), out["val_table"], labels,
                              out["val_rows"], cfg,
                              os.path.join(args.workdir, f"evaluation_report_{name}.json"))
            res["arms"][name] = {"best_val": out["best_val_loss"], "wall_s": wall,
                                 "report": rep}
            out = None
    return res


if __name__ == "__main__":
    main()
