"""Cross-evaluate a checkpoint on every row of a resident collection, per row
region (port of ``tools/exp_cross_eval.py``): the training-free
discriminator for the >150k collapse.

A 176k collection (seed 0, 16 envs) shares its early rows bit-identically
with a 150k collection; rows past ~150k are ticks a model trained on the
150k collection never saw. Scoring a proven-good model on every row:

  - late-row turn errors ~ fresh-holdout level  -> content and paged reads
    are clean at scale; a collapse lives in the training loop;
  - late-row turn errors ~ collapse level       -> the added rows are
    unlearnable or misread.

Rows reach the policy as the training loop reads them: groups of K = 50
batches of B = 120 rows, one launch of the row-gather kernel a group, then
``ops/image.py:normalize`` and the eval forward (bf16 autocast on the card,
as ``load_policy`` builds the model). The last group is padded with copies
of its last batch; the tail under 120 rows is dropped.

    python -m cilrs_tpu_torch.tools.exp_cross_eval [--frames 176256] [--ckpt runs/r5e/ckpt]

``--ckpt`` is a ``.pth`` file or a checkpoint directory (its best slot).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, gather_group
from cilrs_tpu_torch.ops.image import normalize
from cilrs_tpu_torch.tools.exp_label_structure import COMMANDS
from cilrs_tpu_torch.train.checkpoint import load_policy

B, K = 120, 50
BUCKET_ROWS = 8192


@torch.inference_mode()
def eval_group(model: torch.nn.Module, table: dict, idxs: np.ndarray) -> torch.Tensor:
    """idxs [K, B] global rows -> per-row (steer, throttle, brake) [K*B, 3]
    on the table's device: one gather launch, then B rows at a time."""
    batch = gather_group(table, idxs)
    out = []
    for b in range(0, idxs.size, idxs.shape[1]):
        rows = slice(b, b + idxs.shape[1])
        x = normalize(batch["images"][rows].float() / 255.0)
        controls, _ = model(x, batch["speed"][rows], batch["command"][rows])
        out.append(controls.float())
    return torch.cat(out)


def score_rows(model: torch.nn.Module, table: dict, frames: int) -> np.ndarray:
    """Predicted controls [n_eval, 3] of rows [0, n_eval), n_eval = the
    frames in whole batches of B."""
    n_batches = frames // B  # tail remainder (<120 rows) dropped
    all_rows = np.arange(n_batches * B).reshape(n_batches, B)
    preds = np.zeros((n_batches * B, 3), np.float32)
    t0 = time.time()
    for s in range(0, n_batches, K):
        grp = all_rows[s:s + K]
        if len(grp) < K:  # pad the last group with its last batch
            grp_full = np.concatenate([grp, np.repeat(grp[-1:], K - len(grp), axis=0)])
        else:
            grp_full = grp
        out = eval_group(model, table, grp_full).cpu().numpy()
        preds[grp[0, 0]:grp[-1, -1] + 1] = out[:grp.size]
        if (s // K) % 5 == 0:
            print(f"  eval {s}/{n_batches} batches ({time.time()-t0:.0f}s)", flush=True)
    return preds


def region_report(preds: np.ndarray, labels: dict, page_rows: int, frames: int,
                  ckpt: str) -> dict:
    """Steer MAE by region x command and in 8,192-row buckets; printed as
    the JAX tool prints it."""
    n_eval = len(preds)
    cmd = labels["command"][:n_eval]
    true = labels["controls"][:n_eval]
    err = np.abs(preds[:, 0] - true[:, 0])

    # Regions at the structural boundaries: page 1 (the shared prefix), page
    # 2 rows inside the 150k range, and the new >150k tail.
    bounds = [0, page_rows, 150_000, n_eval]
    names = ["page1_(shared_prefix)", "page2_<150k", "page2_>150k_new"]
    out = {"frames": frames, "page_rows": page_rows, "ckpt": ckpt, "regions": {}}
    print(f"\n  {'region':24s} {'rows':>7s}  FOLLOW   LEFT    RIGHT   STRAIGHT")
    for i, name in enumerate(names):
        lo, hi = bounds[i], bounds[i + 1]
        m = {}
        for c, cn in enumerate(COMMANDS):
            sel = (cmd[lo:hi] == c)
            m[cn] = float(err[lo:hi][sel].mean()) if sel.any() else None
            m[cn + "_n"] = int(sel.sum())
        m["steer_mae"] = float(err[lo:hi].mean())
        out["regions"][name] = m
        print(f"  {name:24s} {hi-lo:7d}  "
              + "  ".join(f"{m[cn]:.4f}" if m[cn] is not None else "  -   "
                          for cn in COMMANDS))

    # 8k-row buckets of LEFT+RIGHT error: localizes a bad region (e.g. a
    # page-boundary block) instead of averaging it away.
    buckets = []
    for lo in range(0, n_eval, BUCKET_ROWS):
        hi = min(lo + BUCKET_ROWS, n_eval)
        sel = (cmd[lo:hi] == 1) | (cmd[lo:hi] == 2)
        buckets.append({
            "rows": [lo, hi],
            "turn_mae": float(err[lo:hi][sel].mean()) if sel.any() else None,
            "turn_n": int(sel.sum()),
            "all_mae": float(err[lo:hi].mean()),
        })
    out["buckets_8k"] = buckets
    print("\n  8k-bucket turn MAE:",
          " ".join(f"{b['turn_mae']:.3f}" if b["turn_mae"] is not None else "-"
                   for b in buckets))
    return out


def cross_eval(model: torch.nn.Module, table: dict, labels: dict, frames: int,
               ckpt: str = "") -> tuple[dict, np.ndarray]:
    """(the region report, the per-row predicted controls) of ``model`` on
    rows [0, frames) of ``table``."""
    preds = score_rows(model, table, frames)
    return region_report(preds, labels, int(table["page_rows"]), frames, ckpt), preds


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--ckpt", default="runs/r5e/ckpt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/cross_eval.json")
    p.add_argument("--save-preds", default=None,
                   help="npz path for per-row (pred_controls, true_controls, "
                        "command, speed_kmh) — failure-mode diagnosis")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map("town01")
    table, labels, stats = collect_resident(
        net, args.frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=args.seed, device=dev)
    print(f"  collected {args.frames} frames, pages={stats['num_pages']} "
          f"page_rows={stats['page_rows']}")

    model = load_policy(args.ckpt, load_train_config(), dev)
    out, preds = cross_eval(model, table, labels, args.frames, args.ckpt)
    n_eval = len(preds)
    if args.save_preds:
        np.savez_compressed(args.save_preds, pred=preds, true=labels["controls"][:n_eval],
                            cmd=labels["command"][:n_eval],
                            speed_kmh=labels["speed_kmh"][:n_eval],
                            obstacle_dist=labels["obstacle_dist"][:n_eval],
                            tl_state=labels["tl_state"][:n_eval],
                            env=labels["env"][:n_eval])
        print(f"per-row predictions -> {args.save_preds}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
