"""Fused on-card collect + train CLI (frames never leave the device).

    python -m cilrs_tpu_torch.cli.fused --steps 3000 --envs 32 --ckpt-dir runs/fused [--device cpu]

Runs ``train.fused.fused_collect_train`` on one device and saves the
deployed (EMA) weights to ``<ckpt-dir>/checkpoint_best.pth``, which
``cli.report``, ``cli.drive`` and ``cli.benchmark`` read. The sharded
multi-device run waits for ROADMAP Queue 1 item 7: with more than one GPU
visible, pass ``--single-device``.
"""

from __future__ import annotations

import argparse
import json

import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.train.checkpoint import save_checkpoint
from cilrs_tpu_torch.train.fused import fused_collect_train


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS fused collect+train (PyTorch/CUDA)")
    p.add_argument("--map", default="town01")
    p.add_argument("--steps", type=int, default=2000, help="total train steps")
    p.add_argument("--envs", type=int, default=32)
    p.add_argument("--vehicles", type=int, default=12)
    p.add_argument("--walkers", type=int, default=6)
    p.add_argument("--buffer", type=int, default=65536)
    p.add_argument("--collect-ticks", type=int, default=20)
    p.add_argument("--train-per-chunk", type=int, default=4)
    p.add_argument("--settle-fraction", type=float, default=0.25,
                   help="tail fraction of train steps run with collection "
                        "frozen (multi-epoch pass over the final ring)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--history-json", default=None)
    p.add_argument("--single-device", action="store_true",
                   help="run on one GPU when several are visible")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)
    if dev.type == "cuda" and not args.single_device and torch.cuda.device_count() > 1:
        # The JAX CLI shards over every visible device here; running on one
        # card instead would be a different run, so refuse.
        raise SystemExit(
            f"cli.fused: {torch.cuda.device_count()} GPUs are visible, and the sharded "
            "multi-device fused loop waits for ROADMAP Queue 1 item 7 (parallel/); "
            "pass --single-device to run on one card")

    net = build_map(args.map)
    out = fused_collect_train(
        net, load_train_config(), num_envs=args.envs, num_vehicles=args.vehicles,
        num_pedestrians=args.walkers, buffer_frames=args.buffer,
        collect_ticks=args.collect_ticks, train_steps_per_chunk=args.train_per_chunk,
        total_train_steps=args.steps, seed=args.seed, settle_fraction=args.settle_fraction,
        device=dev)
    print(f"\nfused run: {out['frames_collected']:,} frames collected, "
          f"{out['train_steps']} train steps in {out['wall_s']:.0f}s "
          f"({out['frames_per_sec_train']:,.0f} train frames/s)")
    if out["history"]:
        print(f"final holdout loss: {out['history'][-1]['val_loss']:.4f}")
    if args.ckpt_dir:
        vl = out["history"][-1]["val_loss"] if out["history"] else float("nan")
        save_checkpoint(args.ckpt_dir, out["state"], epoch=1, val_loss=vl, is_best=True)
        print(f"checkpoint -> {args.ckpt_dir}")
    if args.history_json:
        with open(args.history_json, "w") as f:
            json.dump({k: v for k, v in out.items() if k != "state"}, f, indent=2, default=float)
    return out


if __name__ == "__main__":
    main()
