"""Row-region content probe for the >150k collapse (port of
``tools/exp_row_region.py``): train on only the early rows vs only the late
rows of one collection (same train-set size, same val split) and compare
turn-steer errors. If late-row-only training collapses while early-row-only
is healthy, the high rows carry poisonous (image, label) content; if both
arms behave the same, content is exonerated.

    python -m cilrs_tpu_torch.tools.exp_row_region [--frames 176256 --train-rows 80000]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.arms import collect_for_arms, run_arm


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--train-rows", type=int, default=80_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/row_region.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, ds, cfg = collect_for_arms(args.frames, args.epochs, args.seed, dev)
    N = args.frames
    arms = {
        "early_only": np.arange(N) < args.train_rows,
        "late_only": np.arange(N) >= (N - args.train_rows),
    }
    out = {name: run_arm(name, ds, cfg, table, dev, train_row_mask=mask)
           for name, mask in arms.items()}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
