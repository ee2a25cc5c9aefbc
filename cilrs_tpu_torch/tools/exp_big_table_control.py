"""The controlled arm that isolates the big-table OBJECT from the batch
stream (port of ``tools/exp_big_table_control.py``).

Collect a 200k table, but hand ``train`` a labels dataset TRUNCATED to its
first 150k rows. A 150k collection is a bit-identical prefix of the 200k
one, so the stratified split, the sampler stream, the steps an epoch, the
init and every gathered train row equal a 150k run's; the one difference is
the resident table: 200,000 rows (10.56 GB, one page past 2^33 bytes) in
place of 150,000. In the port the question is whether training reads the
same rows the same way from the bigger table (the row-gather kernel's
offsets are 64-bit). The best weights are then scored on a fresh
33,000-frame holdout. The tool sets ``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless
the caller set it, for the duration of ``main``.

    python -m cilrs_tpu_torch.tools.exp_big_table_control [--frames 200000 --truncate 150000]
"""

from __future__ import annotations

import argparse
import os
import time

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
from cilrs_tpu_torch.tools.arms import best_model, fresh_holdout, with_epochs
from cilrs_tpu_torch.tools.exp_checksum import allow_big_table
from cilrs_tpu_torch.train.loop import train


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/r4h")
    p.add_argument("--frames", type=int, default=200_000)
    p.add_argument("--truncate", type=int, default=150_000)
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    net = build_map("town01")
    with allow_big_table():
        print(f"=== collect {args.frames} (train sees first {args.truncate}) ===", flush=True)
        table, labels, _ = collect_resident(
            net, args.frames, num_envs=args.envs, num_vehicles=12, num_pedestrians=6,
            weather_idx=None, seed=args.seed, device=dev)
        labels_t = {k: v[:args.truncate] for k, v in labels.items()}
        cfg = with_epochs(load_train_config(), args.epochs)
        ds = labels_dataset(labels_t)

        t0 = time.time()
        ckpt_dir = os.path.join(args.workdir, "ckpt")
        out = train(ds, cfg, ckpt_dir=ckpt_dir, resident=table, device=dev)
        wall = time.time() - t0
        print(f"best val {out['best_val_loss']:.7f} in {wall:.0f}s "
              f"(r4g reference: 0.0422005)", flush=True)
        model = best_model(cfg, ckpt_dir, dev)

        res = {"frames": args.frames, "truncate": args.truncate,
               "best_val": out["best_val_loss"], "wall_s": wall}
        table = out = None  # free the big table before the fresh collect
        res["fresh"] = fresh_holdout(net, model, cfg, args.envs, args.seed, dev,
                                     os.path.join(args.workdir, "evaluation_report_fresh.json"))
    return res


if __name__ == "__main__":
    main()
