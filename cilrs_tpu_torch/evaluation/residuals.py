"""Residual analysis: where does the remaining behaviour-cloning loss live?
(port of ``cilrs_tpu/evaluation/residuals.py``)

Rolls a fresh collect-mode fleet (teacher labels plus privileged state the
model never sees: obstacle distance, traffic-light state), predicts with a
trained checkpoint, and breaks the per-control residuals down by regime.

    python -m cilrs_tpu_torch.evaluation.residuals --checkpoint runs/fused --frames 20000 [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cilrs_tpu_torch.agent.controller import ST_OK
from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import SPEED_NORM_FACTOR, WEATHER_NAMES, load_train_config
from cilrs_tpu_torch.data.collect import MIN_SPEED_KMH, make_collect_fleet
from cilrs_tpu_torch.ops.image import normalize
from cilrs_tpu_torch.train.checkpoint import load_policy

KEYS = ("frame", "control", "speed_kmh", "command", "obstacle_dist", "tl_state")


def collect_with_privileged(net, num_frames: int, num_envs: int = 32, num_vehicles: int = 12,
                            num_pedestrians: int = 6, seed: int = 123, chunk_steps: int = 50,
                            device="cuda") -> dict:
    """Fresh labelled frames plus privileged features, weathers mixed (env e
    in weather e % 5): host numpy arrays of the first ``num_frames`` moving,
    nominal frames, flattened env-major chunk by chunk."""
    fleet = make_collect_fleet(net, num_envs, num_vehicles, num_pedestrians, None, seed,
                               chunk_steps, device=require_cuda(device))
    cols = {k: [] for k in KEYS + ("weather",)}
    weather = np.repeat(np.arange(num_envs) % len(WEATHER_NAMES), chunk_steps)
    total = 0
    while total < num_frames:
        outs = fleet.chunk()
        flat = {k: outs[k].reshape((-1,) + outs[k].shape[2:]).cpu().numpy()
                for k in KEYS + ("status",)}
        sel = (flat["speed_kmh"] > MIN_SPEED_KMH) & (flat["status"] == ST_OK)
        for k in KEYS:
            cols[k].append(flat[k][sel])
        cols["weather"].append(weather[sel])
        total += int(sel.sum())
    return {k: np.concatenate(v)[:num_frames] for k, v in cols.items()}


@torch.inference_mode()
def predict(ckpt_dir: str, frames: np.ndarray, speed_kmh: np.ndarray, command: np.ndarray,
            batch: int = 256, device="cuda"):
    """The checkpoint's controls [N, 3] and predicted normalized speed [N]
    (host numpy), in batches of ``batch`` with the tail padded by row 0.
    The architecture (speed skip, stage depths) is read from the checkpoint;
    on the card the trunk runs in bf16, as the port's evaluation does."""
    model = load_policy(ckpt_dir, load_train_config(), require_cuda(device))
    dev = next(model.parameters()).device
    n = len(frames)
    idx = np.concatenate([np.arange(n), np.zeros((-n) % batch, np.int64)])
    sp_norm = np.clip(speed_kmh / SPEED_NORM_FACTOR, 0.0, 1.0).astype(np.float32)
    preds, pspeeds = [], []
    for i in range(0, len(idx), batch):
        j = idx[i:i + batch]
        x = normalize(torch.from_numpy(frames[j]).to(dev).float() / 255.0)
        c, ps = model(x, torch.from_numpy(sp_norm[j]).to(dev), torch.from_numpy(command[j]).to(dev))
        preds.append(c.float().cpu().numpy())
        pspeeds.append(ps.float().cpu().numpy())
    return np.concatenate(preds)[:n], np.concatenate(pspeeds)[:n]


def breakdown(data: dict, pred: np.ndarray, pred_speed: np.ndarray) -> dict:
    """MAE and correlation of each control and of the speed head, and the
    controls' MAE by segment: throttle regime, obstacle gating, red or yellow
    light, steer size, weather and command."""
    lab = data["control"]
    res = np.abs(pred - lab)  # [N, 3]
    sp_norm = np.clip(data["speed_kmh"] / SPEED_NORM_FACTOR, 0, 1)
    out = {}

    def corr(a, b):
        if a.std() < 1e-9 or b.std() < 1e-9:
            return float("nan")
        return float(np.corrcoef(a, b)[0, 1])

    out["n"] = len(lab)
    out["mae"] = {k: float(res[:, i].mean()) for i, k in enumerate(("steer", "throttle", "brake"))}
    out["corr"] = {k: corr(pred[:, i], lab[:, i])
                   for i, k in enumerate(("steer", "throttle", "brake"))}
    out["corr"]["speed"] = corr(pred_speed, sp_norm)
    out["speed_mae"] = float(np.abs(pred_speed - sp_norm).mean())

    def seg(name, mask):
        if mask.sum() == 0:
            return
        out.setdefault("segments", {})[name] = {
            "frac": round(float(mask.mean()), 4),
            "steer_mae": round(float(res[mask, 0].mean()), 4),
            "throttle_mae": round(float(res[mask, 1].mean()), 4),
            "brake_mae": round(float(res[mask, 2].mean()), 4),
        }

    th = lab[:, 1]
    seg("th_plateau_hi", th > 0.61)
    seg("th_zero", th < 0.01)
    seg("th_band", (th >= 0.01) & (th <= 0.61))
    seg("gated_obstacle", data["obstacle_dist"] < 25.0)
    seg("free_road", data["obstacle_dist"] >= 25.0)
    seg("red_or_yellow", data["tl_state"] >= 1)
    seg("big_steer", np.abs(lab[:, 0]) > 0.3)
    seg("small_steer", np.abs(lab[:, 0]) <= 0.3)
    for w, nm in enumerate(WEATHER_NAMES):
        seg(f"weather_{nm}", data["weather"] == w)
    for c, nm in enumerate(("FOLLOW", "LEFT", "RIGHT", "STRAIGHT")):
        seg(f"cmd_{nm}", data["command"] == c)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS residual analysis (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--frames", type=int, default=20000)
    p.add_argument("--envs", type=int, default=32)
    p.add_argument("--map", default="town01")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map(args.map)
    data = collect_with_privileged(net, args.frames, num_envs=args.envs, seed=args.seed, device=dev)
    pred, pred_speed = predict(args.checkpoint, data["frame"], data["speed_kmh"], data["command"],
                               device=dev)
    rep = breakdown(data, pred, pred_speed)
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
