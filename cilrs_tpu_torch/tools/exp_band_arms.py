"""Page-residency discriminator (port of ``tools/exp_band_arms.py``): train
on row BANDS of one CONTINUOUS collection (one session across its pages, so
page 2 holds the stream a 150k collection would have).

  arm p2_band: rows [page_rows, 150000): every train row in page 2;
  arm p1_band: rows [26000, page_rows): the same-size page-1 control.

Same val split (the full table) for both. In the JAX package the question
was whether page-2 residency poisons a compiled training program. In the
port one launch of the row-gather kernel serves every page, so the arms ask
the bistability question by row composition, as ``exp_row_region`` does.
The tool sets ``CILRS_TPU_CONTINUOUS_COLLECT=1`` for the duration of
``main`` (the JAX tool set it when imported).

    python -m cilrs_tpu_torch.tools.exp_band_arms [--bands 88128:150000 26000:88128]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.arms import collect_for_arms, run_arm
from cilrs_tpu_torch.tools.exp_checksum import switch_on

CONTINUOUS_SWITCH = "CILRS_TPU_CONTINUOUS_COLLECT"


def band_masks(n: int, page_rows: int, bands: list[str] | None) -> dict:
    """Each arm's train-row mask over the table's n rows: the explicit lo:hi
    bands, or the page-aligned pair."""
    rows = np.arange(n)
    if bands:
        arms = {}
        for b in bands:
            lo, hi = (int(x) for x in b.split(":"))
            arms[f"band_{lo}-{hi}"] = (rows >= lo) & (rows < hi)
        return arms
    return {"p2_band_88k-150k": (rows >= page_rows) & (rows < 150_000),
            "p1_band_26k-88k": (rows >= 26_000) & (rows < page_rows)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bands", nargs="*", default=None,
                   help="explicit lo:hi row bands (overrides the default "
                        "page-aligned arms), e.g. 88128:150000 26000:88128")
    p.add_argument("--out", default="runs/band_arms.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    with switch_on(CONTINUOUS_SWITCH, force=True):
        table, ds, cfg = collect_for_arms(args.frames, args.epochs, args.seed, dev)
        page_rows = int(table["page_rows"])
        print(f"page_rows={page_rows}")
        out = {}
        for name, mask in band_masks(args.frames, page_rows, args.bands).items():
            print(f"arm {name}: {mask.sum()} rows")
            out[name] = run_arm(name, ds, cfg, table, dev, train_row_mask=mask)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
