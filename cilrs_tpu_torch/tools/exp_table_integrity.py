"""Per-row integrity oracle for the resident collection table (port of
``tools/exp_table_integrity.py``).

Weather is assigned per env (env e in weather e % 5 in a mixed collection),
and the night shader (weather 3) darkens frames about fourfold. So a row's
mean brightness against its ENV LABEL is an alignment oracle that needs no
second collection: a row labelled night that is bright (or a day row that
is dark) holds image bytes that do not belong to its labels. The JAX tool
mapped, row by row, where that alignment breaks in a table past 2^33 bytes;
the port reads every row of the table (one page: the row-gather kernel's
offsets are 64-bit) through the kernel, ``--batch`` rows a launch.

The 2^33-byte line is reported in the port's own row units: 52,800-B rows
put it at row 162,688.2 (the JAX table's padded 53,248-B rows at 161,319.4).
The tool sets ``CILRS_TPU_ALLOW_BIG_TABLE=1`` (one page whatever its size)
unless the caller set it, for the duration of ``main``.

    python -m cilrs_tpu_torch.tools.exp_table_integrity --frames 200000   # past 2^33 B
    python -m cilrs_tpu_torch.tools.exp_table_integrity --frames 150000   # control
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.data.resident import collect_resident
from cilrs_tpu_torch.ops.gather import gather_rows_paged
from cilrs_tpu_torch.tools.exp_checksum import allow_big_table

BIN_ROWS = 10_000


def row_means(table: dict, n: int, batch: int) -> np.ndarray:
    """Mean byte of the frame (``image_shape``; a row's tail padding does not
    count) of each of global rows [0, n) of ``table`` (one page or a tuple
    of pages), read through the row-gather kernel ``batch`` rows a launch.
    A row's sum is exact (an integer under 2^24) and is divided on the host
    in float32, as the JAX tool's mean divides it: the card's division by a
    scalar multiplies by its reciprocal, which can differ in the last bit."""
    pages = table["images"] if isinstance(table["images"], tuple) else (table["images"],)
    page_rows = int(table.get("page_rows") or pages[0].shape[0])
    d = int(np.prod(table["image_shape"]))
    means = np.zeros(n, np.float32)
    for s in range(0, n, batch):
        idx = torch.arange(s, min(s + batch, n), dtype=torch.int32, device=pages[0].device)
        sums = gather_rows_paged(pages, idx, page_rows)[:, :d].sum(dim=1, dtype=torch.int64)
        means[s:s + len(idx)] = sums.cpu().numpy().astype(np.float32) / np.float32(d)
    return means


def oracle(means: np.ndarray, env: np.ndarray, row_bytes: int) -> dict:
    """Rows whose brightness puts them on the other side of the night/day
    midpoint (the two label populations' medians) from their env's
    weather: the count, their share by 10k rows, and the 2^33-byte line."""
    n = len(means)
    night = (env % 5) == 3
    if not (night.any() and (~night).any()):
        raise ValueError("the weather-alignment oracle needs a MIXED-weather collection "
                         "(night and non-night rows); this table has only one population — "
                         "collect with weather_idx=None")
    med_n = float(np.median(means[night]))
    med_d = float(np.median(means[~night]))
    thr = 0.5 * (med_n + med_d)
    mismatch = (means < thr) != night
    print(f"night-label median {med_n:.1f}, day-label median {med_d:.1f}, "
          f"threshold {thr:.1f}")
    print(f"TOTAL label<->image weather mismatches: {int(mismatch.sum())} "
          f"/ {n} ({100.0 * mismatch.mean():.2f}%)")
    bins = []
    for lo in range(0, n, BIN_ROWS):
        m = mismatch[lo:lo + BIN_ROWS]
        bins.append({"row_lo": lo, "mismatch_frac": round(float(m.mean()), 4)})
        print(f"  rows {lo:>7}-{lo + len(m):>7}: mismatch {m.mean():7.2%}")
    wrap_row = (2 ** 33) / row_bytes
    print(f"row bytes {row_bytes}, 2^33-byte boundary at row {wrap_row:.1f}")
    return {"frames": n, "row_bytes": row_bytes, "wrap_row": wrap_row, "threshold": thr,
            "total_mismatch": int(mismatch.sum()), "bins": bins}


def integrity(table: dict, env: np.ndarray, n: int, batch: int) -> dict:
    """The oracle over global rows [0, n) of ``table``."""
    pages = table["images"] if isinstance(table["images"], tuple) else (table["images"],)
    return oracle(row_means(table, n, batch), env, pages[0][0].numel() * pages[0].element_size())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=200_000)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    with allow_big_table():
        table, labels, _ = collect_resident(
            build_map("town01"), args.frames, num_envs=args.envs, num_vehicles=12,
            num_pedestrians=6, weather_idx=None, seed=args.seed, device=dev)
    out = integrity(table, labels["env"], args.frames, args.batch)

    path = args.out or f"runs/table_integrity_{args.frames}.json"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {path}")
    return out


if __name__ == "__main__":
    main()
