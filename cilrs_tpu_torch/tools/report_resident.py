"""Offline evaluation report of a resident-pipeline checkpoint, standalone
(port of ``tools/report_resident.py``).

The resident pipeline (``cli.pipeline --resident``) keeps its frames on the
card only: when the process exits the table is gone. The simulator is
deterministic given (seed, frames, envs, vehicles, walkers, map), so
re-collecting with ``data/resident.py:collect_resident`` rebuilds the same
table, frames and labels, and the offline report (``evaluation/report.py``)
runs against any surviving checkpoint without retraining:

    # the trainer's stratified val split of the collection
    python -m cilrs_tpu_torch.tools.report_resident --checkpoint runs/r/ckpt \\
        --frames 200000 --seed 0 --split val --out runs/r/evaluation_report.json

    # a fresh holdout (a seed no training collection used), every frame
    python -m cilrs_tpu_torch.tools.report_resident --checkpoint runs/r/ckpt \\
        --frames 33000 --seed 777777 --split all --out runs/r/evaluation_report_fresh.json

``--checkpoint`` is a ``.pth`` file or a checkpoint directory (its best
slot), as ``cli.report`` reads it. The frames reach the policy through the
row-gather kernel. ``--device`` (default ``cuda``) is the port's addition.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.dataset import stratified_split
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
from cilrs_tpu_torch.evaluation.report import (collect_predictions_resident, offline_report,
                                               save_report)
from cilrs_tpu_torch.train.checkpoint import load_policy


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="resident-checkpoint offline report (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--vehicles", type=int, default=12)
    p.add_argument("--walkers", type=int, default=6)
    p.add_argument("--map", default="town01")
    p.add_argument("--split", choices=["val", "all"], default="val",
                   help="'val': the trainer's stratified val split of the "
                        "collection; 'all': every collected frame (holdout)")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    cfg = load_train_config()
    net = build_map(args.map)
    print(f"=== re-collect {args.frames} frames (seed {args.seed}) ===")
    table, labels, stats = collect_resident(
        net, args.frames, num_envs=args.envs, num_vehicles=args.vehicles,
        num_pedestrians=args.walkers, weather_idx=None, seed=args.seed, device=dev)
    print(f"  {args.frames} frames at {stats['frames_per_sec']:.0f}/s")

    if args.split == "val":
        _, rows = stratified_split(labels_dataset(labels), cfg.training.val_fraction,
                                   cfg.training.seed)
    else:
        rows = np.arange(args.frames)
    print(f"  evaluating {len(rows)} rows")

    model = load_policy(args.checkpoint, cfg, dev)
    pred, true, cmd = collect_predictions_resident(model, table, labels, np.asarray(rows),
                                                   cfg.training.batch_size, cfg)
    # Mixed-weather collections put env e in weather e % 5.
    report = offline_report(pred, true, cmd, weather=labels["env"][rows] % 5)
    save_report(report, args.out)
    print(json.dumps({k: report[k] for k in ("num_samples", "steer", "brake", "speed")},
                     indent=2))
    print(f"full report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
