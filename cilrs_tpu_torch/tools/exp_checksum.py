"""Bitwise cross-collection checksum audit of the resident table (port of
``tools/exp_checksum.py``).

Determinism gives an oracle: a small collection is a bit-identical prefix of
a big one (same seed and envs), so per-row image checksums must match too.
This tool:

  phase 1: collects ``--small`` frames and checksums every row through the
           row-gather kernel;
  phase 2: frees it, collects ``--big`` frames and checksums every row both
           through the kernel and through plain slices of the table;
  compare: (a) big vs small checksums on the first ``--small`` rows: a
           mismatch is write-side corruption that shows only in big tables;
           (b) kernel vs plain slices on every row of the big table: a
           divergence is read-side corruption in the gather kernel.

The checksums of a row are its sum and its position-weighted sum (weights
``arange(D) % 251 + 1``), in int64 here (torch has no uint32 reductions):
under 2^32 for a frame (52,800 x 255 x 251 = 3.38e9), so they equal the JAX
tool's uint32 sums. Both collections are one page: the tool sets
``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless the caller set it, for the duration
of ``main``. The port's rows are 52,800 B (16-byte aligned), so the 2^33-byte
line falls at row 162,690 (the JAX table's 53,248-B rows put it at 161,320).

Caveat (paged tables): the prefix oracle only holds within one page; a paged
collection drops up to M-1 overshoot frames at each page rollover.

    python -m cilrs_tpu_torch.tools.exp_checksum [--small 150000 --big 200000]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.data.resident import collect_resident, unwrap_monolithic
from cilrs_tpu_torch.ops.gather import gather_rows_paged

BIG_TABLE_SWITCH = "CILRS_TPU_ALLOW_BIG_TABLE"
WEIGHT_MOD = 251


@contextlib.contextmanager
def switch_on(name: str, force: bool = False):
    """The switch ``name`` set to 1 (unless already set, or whatever it was
    with ``force``), then the environment as it was."""
    prior = os.environ.get(name)
    if force or prior is None:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prior


def allow_big_table():
    """``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless already set, then the
    environment as it was."""
    return switch_on(BIG_TABLE_SWITCH)


def row_checksums(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (sum, weighted sum) of [b, d] u8 rows, int64 on their device."""
    w = torch.arange(rows.shape[1], dtype=torch.int32, device=rows.device) % WEIGHT_MOD + 1
    r = rows.to(torch.int32)
    return r.sum(dim=1, dtype=torch.int64), (r * w).sum(dim=1, dtype=torch.int64)


def _indices(lo: int, hi: int, dev) -> torch.Tensor:
    return torch.arange(lo, hi, dtype=torch.int32, device=dev)


def checksums_gather(pages, page_rows: int, n: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """(sum, weighted sum) of global rows [0, n) read through the row-gather
    kernel, ``batch`` rows a launch."""
    s = np.zeros(n, np.int64)
    h = np.zeros(n, np.int64)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        a, b = row_checksums(gather_rows_paged(pages, _indices(lo, hi, pages[0].device),
                                               page_rows))
        s[lo:hi] = a.cpu().numpy()
        h[lo:hi] = b.cpu().numpy()
    return s, h


def checksums_slice(pages, page_rows: int, n: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The same sums through plain slices of each page (no kernel), page by
    page, ``batch`` rows a slice."""
    s = np.zeros(n, np.int64)
    h = np.zeros(n, np.int64)
    for p, page in enumerate(pages):
        g0 = p * page_rows
        g1 = n if p == len(pages) - 1 else min(g0 + page_rows, n)
        for lo in range(g0, g1, batch):
            hi = min(lo + batch, g1)
            a, b = row_checksums(page[lo - g0:hi - g0].reshape(hi - lo, -1))
            s[lo:hi] = a.cpu().numpy()
            h[lo:hi] = b.cpu().numpy()
    return s, h


def read_audit(pages, page_rows: int, n: int, batch: int) -> np.ndarray:
    """Rows of [0, n) whose checksums through the kernel and through plain
    slices differ."""
    s_g, h_g = checksums_gather(pages, page_rows, n, batch)
    s_d, h_d = checksums_slice(pages, page_rows, n, batch)
    return np.where((s_g != s_d) | (h_g != h_d))[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--small", type=int, default=150_000)
    p.add_argument("--big", type=int, default=200_000)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--out", default="runs/checksum_audit.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map("town01")

    def collect(n: int) -> torch.Tensor:
        table, _, _ = collect_resident(net, n, num_envs=args.envs, num_vehicles=12,
                                       num_pedestrians=6, weather_idx=None, seed=args.seed,
                                       device=dev)
        return unwrap_monolithic(table)["images"]

    with allow_big_table():
        print(f"=== phase 1: collect {args.small} (safe size) ===", flush=True)
        imgs = collect(args.small)
        s_small, h_small = checksums_gather((imgs,), imgs.shape[0], args.small, args.batch)
        del imgs
        gc.collect()

        print(f"=== phase 2: collect {args.big} (past 2^33 bytes) ===", flush=True)
        imgs = collect(args.big)
        s_big_g, h_big_g = checksums_gather((imgs,), imgs.shape[0], args.big, args.batch)
        s_big_d, h_big_d = checksums_slice((imgs,), imgs.shape[0], args.big, args.batch)

    row_bytes = imgs.shape[1] * imgs.element_size()
    wrap_row = (2 ** 33) / row_bytes

    # (a) write integrity: prefix rows must match across collections
    wmis = np.where((s_big_g[:args.small] != s_small)
                    | (h_big_g[:args.small] != h_small))[0]
    print(f"WRITE audit: {len(wmis)} / {args.small} prefix rows differ "
          f"between the {args.small} and {args.big} collections")
    if len(wmis):
        print(f"  first/last mismatched rows: {wmis[:5].tolist()} ... "
              f"{wmis[-5:].tolist()}")
        frac_bins = [round(float(((wmis >= lo) & (wmis < lo + 10_000)).sum())
                           / 10_000, 4) for lo in range(0, args.small, 10_000)]
        print(f"  mismatch frac per 10k rows: {frac_bins}")

    # (b) read integrity: the kernel vs plain slices on the big table
    rmis = np.where((s_big_g != s_big_d) | (h_big_g != h_big_d))[0]
    print(f"READ audit: {len(rmis)} / {args.big} rows differ between "
          f"gather_rows and dynamic_slice (2^33 boundary at row {wrap_row:.1f})")
    if len(rmis):
        print(f"  first/last mismatched rows: {rmis[:5].tolist()} ... "
              f"{rmis[-5:].tolist()}")
        below = int((rmis < int(wrap_row)).sum())
        print(f"  {below} below the boundary, {len(rmis) - below} at/above")

    out = {
        "small": args.small, "big": args.big, "row_bytes": row_bytes,
        "wrap_row": wrap_row,
        "write_mismatches": int(len(wmis)),
        "write_first": wmis[:20].tolist() if len(wmis) else [],
        "read_mismatches": int(len(rmis)),
        "read_first": rmis[:20].tolist() if len(rmis) else [],
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
