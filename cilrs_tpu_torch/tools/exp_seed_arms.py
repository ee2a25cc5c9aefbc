"""Bistability test: is the >150k turn collapse a training-stream coin flip?
(port of ``tools/exp_seed_arms.py``)

Arms: the full split of one collection trained with different stream seeds
(init, sampler and augmentation only: the split and the val rows stay at the
config's seed, so val errors are comparable). A healthy seed among collapsed
ones shows that turn learning is bistable, decided by the early training
trajectory, and turns a capability problem into an optimization-
stabilization problem.

    python -m cilrs_tpu_torch.tools.exp_seed_arms [--seeds 43 137 1009]
"""
from __future__ import annotations

import argparse
import json

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.arms import collect_for_arms, run_arm


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--seed", type=int, default=0, help="collection seed")
    p.add_argument("--seeds", type=int, nargs="+", default=[43, 137, 1009])
    p.add_argument("--out", default="runs/seed_arms.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, ds, cfg = collect_for_arms(args.frames, args.epochs, args.seed, dev)
    out = {}
    for s in args.seeds:
        out[f"stream_seed_{s}"] = run_arm(f"stream_seed_{s}", ds, cfg, table, dev,
                                          stream_seed=s)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
