"""The readings that a cell's limits are set from, on the card at the cell's
own size: for each seed, what the check reads of the program (the lower
reading) and of the control, the reference one precision down (the upper),
and with ``--fault`` of the program with that fault planted (``faults.py``).
No window is measured: each seed runs the cell's set-up and the chunk or the
steps that its check compares. The benchmark's runs never run this.

    python -m portbench.calibrate --workload CELL --seeds 11,12,13 [--fault half] [--no-control]

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None, choices=("unchanged", "half", "altered", "forgetful"))
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--fp32", action="store_true",
                   help="a witness: the program's policy in float32 (its autocast off)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: the readings are taken on a CUDA device; none is present",
              file=sys.stderr)
        return 2
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    driver = harness.load_module("drivers", workload["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Ctx(cell=args.workload, workload=workload, config=config, seed=seed,
                          seconds=0.0, trace=False, device=torch.device("cuda"),
                          t_start=t0)
        if args.fault is None:
            out = driver.calibrate(ctx, control=not args.no_control, fp32=args.fp32)
        elif workload["driver"] == "train":
            with faults.train_fault(args.fault):
                out = driver.calibrate(ctx, control=False)
        else:
            out = driver.calibrate(ctx, control=False, fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
