"""Two-stage curriculum: widen a turn-latched model to the full split (port
of ``tools/exp_stage2.py``).

Turn learning from scratch is bistable: a stream either latches onto the
arc features or settles into the predict-the-mean basin. If the latched
basin is stable under continued training on the full split, a two-stage
curriculum (latch on a proven recipe, then widen) lands the reference-scale
run. This arm initializes from a checkpoint's best slot (``--init``, a
checkpoint directory) and trains the full split for ``--epochs``.

    python -m cilrs_tpu_torch.tools.exp_stage2 [--init runs/r5e/ckpt]
"""
from __future__ import annotations

import argparse
import json
import time

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.arms import collect_for_arms, train_arm


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default="runs/r5e/ckpt")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--out", default="runs/stage2.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, ds, cfg = collect_for_arms(args.frames, args.epochs, args.seed, dev)
    t0 = time.time()
    res = train_arm(ds, cfg, table, dev, init_from=args.init, ckpt_dir=args.ckpt_dir)
    h = res["history"]
    out = {"frames": args.frames, "init": args.init, "history": h,
           "best_val": res["best_val_loss"], "wall_s": time.time() - t0}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nfinal: val {h[-1]['val_loss']:.4f} "
          f"LEFT {h[-1]['steer_err_LEFT']:.4f} "
          f"RIGHT {h[-1]['steer_err_RIGHT']:.4f}")
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
