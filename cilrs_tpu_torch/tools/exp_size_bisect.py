"""Train-split size bisect on one fixed collection (port of
``tools/exp_size_bisect.py``): the arms are random train-split subsamples
of increasing size (``max_train_frames``, ``train/loop.py``) at the same
full-range membership distribution, with the val split fixed across arms.
It brackets a collapse threshold in train rows.

    python -m cilrs_tpu_torch.tools.exp_size_bisect --sizes 100000 127500 140000
"""
from __future__ import annotations

import argparse
import json

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.arms import collect_for_arms, run_arm


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[100_000, 127_500, 149_817])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/size_bisect.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, ds, cfg = collect_for_arms(args.frames, args.epochs, args.seed, dev)
    out = {}
    for size in args.sizes:
        out[f"size_{size}"] = run_arm(f"size_{size}", ds, cfg, table, dev,
                                      max_train_frames=size)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
