"""Offline model evaluation CLI -> evaluation_report.json.

    python -m cilrs_tpu_torch.cli.report --data data/session_001 \
        --checkpoint checkpoint_best.pth --out evaluation_report.json

Loads the sessions, takes the seed-42 stratified val split, ships it to the
card once as a resident table and evaluates it there: frames reach the policy
through the row-gather kernel, one launch per group of 25 batches.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.dataset import load_sessions, stratified_split
from cilrs_tpu_torch.data.resident import ship_resident
from cilrs_tpu_torch.evaluation.report import (
    collect_predictions_resident, offline_report, save_report)
from cilrs_tpu_torch.train.checkpoint import load_policy


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS offline evaluation report (PyTorch/CUDA)")
    p.add_argument("--data", nargs="+", required=True, help="session directories")
    p.add_argument("--checkpoint", required=True, help="notebook-format .pth file")
    p.add_argument("--out", default="evaluation_report.json")
    p.add_argument("--batch-size", type=int, default=120)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    cfg = load_train_config()
    ds = load_sessions(args.data)
    _, val_idx = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
    print(f"  evaluating on {len(val_idx)} val samples")

    model = load_policy(args.checkpoint, cfg, dev)
    table = ship_resident(ds, dev, idx=val_idx)
    labels = {"speed": ds.speed_norm[val_idx], "command": ds.command[val_idx],
              "controls": ds.controls[val_idx]}
    pred, true, cmd = collect_predictions_resident(
        model, table, labels, np.arange(len(val_idx)), args.batch_size, cfg)
    report = offline_report(pred, true, cmd)
    save_report(report, args.out)
    print(json.dumps({k: report[k] for k in ("num_samples", "steer")}, indent=2))
    print(f"full report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
