"""Behavioral eval-causality test (port of ``tools/exp_noeval_train.py``):
train with epoch-end validation disabled for the first epochs
(``train/loop.py`` ``eval_every``), then validate once at the last epoch.

If an interleaved eval dispatch poisoned training, the eval-free epochs
train healthily and the single late validation reads healthy turn errors.
The checkpoint is saved (``runs/noeval/ckpt``) so that an independent scorer
(``tools/exp_cross_eval.py --ckpt runs/noeval/ckpt``) can measure the model
outside the loop's own eval.

    python -m cilrs_tpu_torch.tools.exp_noeval_train [--epochs 7 --eval-every 7]
"""
from __future__ import annotations

import argparse
import json
import time

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.tools.arms import collect_for_arms, train_arm

CKPT_DIR = "runs/noeval/ckpt"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--epochs", type=int, default=7)
    p.add_argument("--eval-every", type=int, default=7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/noeval_train.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    table, ds, cfg = collect_for_arms(args.frames, args.epochs, args.seed, dev)
    t0 = time.time()
    res = train_arm(ds, cfg, table, dev, eval_every=args.eval_every, ckpt_dir=CKPT_DIR)
    h = res["history"]
    out = {
        "frames": args.frames,
        "eval_every": args.eval_every,
        "history": h,
        "final": h[-1],
        "wall_s": time.time() - t0,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nfinal epoch: val {h[-1]['val_loss']:.4f} "
          f"LEFT {h[-1]['steer_err_LEFT']:.4f} "
          f"RIGHT {h[-1]['steer_err_RIGHT']:.4f}")
    print("reference points: r5e epoch-7 LEFT 0.019 (healthy) | "
          "r6a epoch-7 LEFT 0.078 (collapsed)")
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
