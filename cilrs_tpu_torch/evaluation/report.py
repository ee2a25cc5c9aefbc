"""Offline model evaluation: the evaluation_report.json metrics.

Port of ``cilrs_tpu/evaluation/report.py``. ``offline_report`` and
``save_report`` are the same numpy code. ``collect_predictions_resident`` runs
the policy over rows of a card-resident table: per group of K=25 batches,
``data.resident.gather_group`` brings the group's frames with one launch of
the row-gather kernel and its labels by plain indexing, and only the [N, 4]
predictions cross to the host.
``collect_predictions`` is the host-batch path.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from cilrs_tpu_torch.config import COMMAND_NAMES, WEATHER_NAMES
from cilrs_tpu_torch.data.resident import gather_group
from cilrs_tpu_torch.train.steps import make_eval_step

CONTROL_NAMES = ("steer", "throttle", "brake", "speed")
ACCURACY_THRESHOLDS = (0.01, 0.05, 0.1)
PERCENTILES = (50, 75, 90, 95, 99)
GROUP_BATCHES = 25  # batches per gather launch, as the JAX package's scanned groups


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    if a.std() < 1e-9 or b.std() < 1e-9:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def offline_report(
    pred: np.ndarray,  # [N, 4] steer, throttle, brake, pred_speed(norm)
    true: np.ndarray,  # [N, 4] same layout (speed normalized)
    command: np.ndarray,  # [N]
    weather: np.ndarray | None = None,  # [N] weather index (0..4), optional
) -> dict:
    report: dict = {"num_samples": int(len(pred))}
    for k, name in enumerate(CONTROL_NAMES):
        err = pred[:, k] - true[:, k]
        report[name] = {
            "mae": float(np.abs(err).mean()),
            "mse": float((err ** 2).mean()),
            "rmse": float(np.sqrt((err ** 2).mean())),
            "correlation": _corr(pred[:, k], true[:, k]),
        }
    per_cmd = {}
    steer_err = np.abs(pred[:, 0] - true[:, 0])
    for c, cname in enumerate(COMMAND_NAMES):
        mask = command == c
        if mask.sum() == 0:
            continue
        per_cmd[cname] = {
            "samples": int(mask.sum()),
            "steer_mae": float(steer_err[mask].mean()),
            "steer_rmse": float(np.sqrt(((pred[mask, 0] - true[mask, 0]) ** 2).mean())),
        }
    report["per_command"] = per_cmd
    report["steer_percentiles"] = {
        f"p{p}": float(np.percentile(steer_err, p)) for p in PERCENTILES
    }
    report["steer_accuracy"] = {
        f"within_{t}": float((steer_err <= t).mean()) for t in ACCURACY_THRESHOLDS
    }
    if weather is not None:
        # Localizes weather-conditional failure that the aggregate
        # correlations average away.
        per_w = {}
        for w, wname in enumerate(WEATHER_NAMES):
            mask = weather == w
            if mask.sum() == 0:
                continue
            per_w[wname] = {"samples": int(mask.sum())}
            for k, name in enumerate(CONTROL_NAMES):
                err = pred[mask, k] - true[mask, k]
                per_w[wname][name] = {
                    "mae": float(np.abs(err).mean()),
                    "correlation": _corr(pred[mask, k], true[mask, k]),
                }
        report["per_weather"] = per_w
    return report


def save_report(report: dict, path: str):
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def collect_predictions_resident(model: torch.nn.Module, table: dict, labels: dict,
                                 idx: np.ndarray, batch: int, cfg) -> tuple:
    """Predictions for global rows ``idx`` of a resident table (the dict that
    ``data.resident.ship_resident`` returns), in batches of ``batch`` on the
    table's device. ``labels`` holds the same labels as host numpy.

    Returns (pred [N,4], true [N,4], command [N]) as numpy.
    """
    eval_step = make_eval_step(cfg)
    preds = []
    group = batch * GROUP_BATCHES
    for s in range(0, len(idx), group):
        rows = idx[s:s + group]
        n_rows = len(rows)
        # Pad the tail group to a batch multiple by cycling rows (np.resize
        # repeats, so it works even when the tail is shorter than one batch);
        # the padded predictions are trimmed right back off.
        padded = np.resize(rows, -(-n_rows // batch) * batch)
        frames = gather_group(table, padded)
        outs = [eval_step(model, {k: v[b:b + batch] for k, v in frames.items()})["pred"]
                for b in range(0, len(padded), batch)]
        preds.append(torch.cat(outs)[:n_rows].cpu().numpy())
    pred = np.concatenate(preds) if preds else np.zeros((0, 4))
    true = np.concatenate(
        [labels["controls"][idx], labels["speed"][idx][:, None]], axis=1)
    return pred, true, labels["command"][idx]


def collect_predictions(model: torch.nn.Module, ds, idx: np.ndarray, batch: int,
                        eval_step) -> tuple:
    """Run eval_step over idx in host batches on the model's device (a partial
    tail batch is dropped); returns (pred [N,4], true [N,4], cmd)."""
    dev = next(model.parameters()).device
    preds = []
    n = (len(idx) // batch) * batch
    for s in range(0, n, batch):
        b = idx[s:s + batch]
        parts = eval_step(model, {
            "images": torch.from_numpy(ds.images[b]).to(dev),
            "speed": torch.from_numpy(ds.speed_norm[b]).to(dev),
            "command": torch.from_numpy(ds.command[b]).to(dev),
            "controls": torch.from_numpy(ds.controls[b]).to(dev),
        })
        preds.append(parts["pred"].cpu().numpy())
    pred = np.concatenate(preds) if preds else np.zeros((0, 4))
    used = idx[:n]
    true = np.concatenate([ds.controls[used], ds.speed_norm[used][:, None]], axis=1)
    return pred, true, ds.command[used]
