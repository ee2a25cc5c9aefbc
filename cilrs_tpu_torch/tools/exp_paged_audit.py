"""Full-scale paged-table audit: gather exactness + weather-alignment oracle
(port of ``tools/exp_paged_audit.py``).

 1. Every row of a paged collection read through the row-gather kernel
    (``batch`` rows a launch, every page in one launch) against plain reads
    of its page, a plain and a position-weighted checksum per row
    (``tools/exp_checksum.py``'s sums).
 2. The weather-brightness oracle: a row's mean brightness against the
    median of night and of day rows (env e in weather e % 5, night = 3);
    the rows on the wrong side of the midpoint, by 20k rows, by page and by
    env. A row's mean divides its sum by the port's 52,800-B row (the JAX
    tool's by its padded 53,248-B row, so its medians read 52,800 / 53,248
    of these; the masks are the same).

    python -m cilrs_tpu_torch.tools.exp_paged_audit [--frames 176256]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.data.resident import collect_resident
from cilrs_tpu_torch.ops.gather import gather_rows_paged
from cilrs_tpu_torch.tools.exp_checksum import row_checksums

BATCH = 4096
NUM_ENVS = 16
_T0 = time.time()


def log(*a):
    print(f"[{time.time()-_T0:6.1f}s]", *a, flush=True)


def sweep(table: dict, n: int, batch: int = BATCH) -> tuple[int, np.ndarray]:
    """(mismatching checksums, per-row mean brightness [n] float32) over
    global rows [0, n): the kernel's reads against plain reads of each page."""
    pages = table["images"]
    pr = int(table["page_rows"])
    dev = pages[0].device
    bad = 0
    means = np.zeros(n, np.float32)
    for s in range(0, n, batch):
        idx = np.arange(s, min(s + batch, n), dtype=np.int32)
        sg, hg = (x.cpu().numpy() for x in row_checksums(
            gather_rows_paged(pages, torch.from_numpy(idx).to(dev), pr)))
        pg_id = idx // pr
        local = idx - pg_id * pr
        hd = np.zeros_like(hg)
        sd = np.zeros_like(sg)
        for p in range(len(pages)):
            m = pg_id == p
            if m.any():
                rows = pages[p][torch.from_numpy(local[m]).to(dev).long()]
                s2, h2 = (x.cpu().numpy() for x in row_checksums(rows.reshape(len(rows), -1)))
                hd[m] = h2
                sd[m] = s2
        bad += int((hg != hd).sum() + (sg != sd).sum())
        means[s:s + len(idx)] = sg / pages[0].shape[1]
        if s % (batch * 8) == 0:
            log(f"swept {s}/{n} bad={bad}")
    log(f"EXACTNESS: {bad} mismatching checksums over {n} rows (paged gather vs dynamic_slice)")
    return bad, means


def weather_oracle(means: np.ndarray, env: np.ndarray, page_rows: int) -> dict:
    """Rows whose brightness puts them on the other side of the night/day
    midpoint from their env's weather, overall, by 20k rows, page and env."""
    n = len(means)
    night = (env % 5) == 3
    med_n, med_d = np.median(means[night]), np.median(means[~night])
    thr = 0.5 * (med_n + med_d)
    mism = (means < thr) != night
    log(f"ORACLE: {mism.sum()}/{n} mismatches ({100*mism.mean():.2f}%), "
        f"med_n={med_n:.1f} med_d={med_d:.1f}")
    by_rows = []
    for lo in range(0, n, 20000):
        m = mism[lo:lo + 20000]
        by_rows.append(float(100 * m.mean()))
        print(f"  rows {lo:>7}+: {100*m.mean():6.2f}%", flush=True)
    by_page = []
    for p in range(-(-n // page_rows)):
        m = mism[(np.arange(n) // page_rows) == p]
        by_page.append(float(100 * m.mean()))
        print(f"  page {p}: {100*m.mean():.2f}%")
    by_env = [(e, round(100 * mism[env == e].mean(), 2)) for e in range(NUM_ENVS)]
    print("  by env:", by_env, flush=True)
    return {"mismatches": int(mism.sum()), "rows": n, "med_n": float(med_n),
            "med_d": float(med_d), "pct_by_20k_rows": by_rows, "pct_by_page": by_page,
            "pct_by_env": [[e, float(v)] for e, v in by_env]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map("town01")
    N = args.frames
    table, labels, stats = collect_resident(net, N, num_envs=NUM_ENVS, num_vehicles=12,
                                            num_pedestrians=6, weather_idx=None, seed=0,
                                            device=dev)
    log("collected", stats["num_pages"], "pages, page_rows", table["page_rows"])
    bad, means = sweep(table, N)
    return {"frames": N, "pages": stats["num_pages"], "page_rows": int(table["page_rows"]),
            "exactness_mismatches": bad,
            "oracle": weather_oracle(means, labels["env"], int(table["page_rows"]))}


if __name__ == "__main__":
    main()
