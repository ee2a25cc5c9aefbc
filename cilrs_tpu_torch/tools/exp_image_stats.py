"""Per-region image statistics of a 176k collection (port of
``tools/exp_image_stats.py``): do the >150k / page-2 frames form a distinct
visual domain?

Samples rows per (region x weather) cell through the row-gather kernel
(``ops/gather.py:gather_rows_paged``, one launch a cell) and reports
mean/std brightness, per-channel means, and the fraction of saturated
pixels. A systematic shift (renderer state drifting with sim time, or a
fresh-session difference) would split turn supervision into two
visually-discriminable domains.

    python -m cilrs_tpu_torch.tools.exp_image_stats [--frames 176256 --per-cell 240]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import WEATHER_NAMES
from cilrs_tpu_torch.data.resident import collect_resident
from cilrs_tpu_torch.ops.gather import gather_rows_paged
from cilrs_tpu_torch.tools.exp_label_structure import row_regions


def image_stats(table: dict, labels: dict, per_cell: int) -> dict:
    """Statistics of ``RandomState(0)`` picks of ``per_cell`` rows in every
    region x weather cell (env e in weather e % 5); printed as the JAX tool
    prints them."""
    pages = table["images"]
    page_rows = int(table["page_rows"])
    img_shape = tuple(table["image_shape"])
    D = int(np.prod(img_shape))
    weather = labels["env"] % 5
    rng = np.random.RandomState(0)
    out = {}
    print(f"{'region':14s} {'weather':9s} {'mean':>7s} {'std':>7s} "
          f"{'R':>6s} {'G':>6s} {'B':>6s} {'sat%':>6s}")
    for rname, rsel in row_regions(len(weather)).items():
        out[rname] = {}
        for w in range(5):
            sel = np.nonzero(rsel & (weather == w))[0]
            if len(sel) == 0:
                continue
            pick = np.sort(rng.choice(sel, min(per_cell, len(sel)), replace=False))
            idx = torch.from_numpy(pick.astype(np.int32)).to(pages[0].device)
            imgs = gather_rows_paged(pages, idx, page_rows)[:, :D].cpu().numpy()
            imgs = imgs.reshape((-1,) + img_shape).astype(np.float32)
            m = {
                "n": len(pick),
                "mean": float(imgs.mean()),
                "std": float(imgs.std()),
                "rgb": [float(imgs[..., c].mean()) for c in range(3)],
                "sat_frac": float(np.mean(imgs >= 250.0)),
            }
            out[rname][WEATHER_NAMES[w]] = m
            print(f"{rname:14s} {WEATHER_NAMES[w]:9s} {m['mean']:7.2f} {m['std']:7.2f} "
                  f"{m['rgb'][0]:6.1f} {m['rgb'][1]:6.1f} {m['rgb'][2]:6.1f} "
                  f"{100 * m['sat_frac']:6.2f}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--per-cell", type=int, default=240)
    p.add_argument("--out", default="runs/image_stats.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map("town01")
    table, labels, _ = collect_resident(
        net, args.frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=args.seed, device=dev)
    out = image_stats(table, labels, args.per_cell)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
