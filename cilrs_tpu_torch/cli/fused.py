"""Fused on-card collect + train CLI (frames never leave the device).

    python -m cilrs_tpu_torch.cli.fused --steps 3000 --envs 32 --ckpt-dir runs/fused [--device cpu]
    torchrun --nproc_per_node N -m cilrs_tpu_torch.cli.fused --steps 3000 --envs 32 ...

Runs ``train.fused.fused_collect_train`` and saves the deployed (EMA)
weights to ``<ckpt-dir>/checkpoint_best.pth``, which ``cli.report``,
``cli.drive`` and ``cli.benchmark`` read. Under torchrun (any world size,
1 included) the fleet and the ring shard over the ranks, one GPU each
(``parallel/``), and rank 0 writes the checkpoint and the history. A plain
launch runs on one device; with more than one GPU visible it refuses, since
the JAX CLI would shard over all of them: launch it with torchrun, or pass
``--single-device`` (which torchrun with more than one rank refuses).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.parallel.distributed import initialize_distributed, is_coordinator
from cilrs_tpu_torch.parallel.mesh import make_mesh
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
                   help="run on one GPU when several are visible (no torchrun)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)
    if args.single_device and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # Every rank would run the whole loop and write the same files.
        raise SystemExit("cli.fused: --single-device runs one process; launch it without "
                         "torchrun, or drop the flag to shard over the ranks")
    # The process group first: it sets this rank's GPU before any CUDA work.
    mesh = None
    if not args.single_device and initialize_distributed(device=dev):
        mesh = make_mesh(device=dev.type)
        dev = mesh.device
        if mesh.rank == 0:
            print(f"  mesh: a world of {mesh.world} (fleet + ring sharded, gradients averaged)")
    elif dev.type == "cuda" and not args.single_device and torch.cuda.device_count() > 1:
        # The JAX CLI shards over every visible device here; running on one
        # card instead would be a different run, so refuse.
        raise SystemExit(
            f"cli.fused: {torch.cuda.device_count()} GPUs are visible; shard over them with "
            f"torchrun --nproc_per_node {torch.cuda.device_count()} -m cilrs_tpu_torch.cli.fused "
            "..., or pass --single-device to run on one card")

    net = build_map(args.map)
    out = fused_collect_train(
        net, load_train_config(), num_envs=args.envs, num_vehicles=args.vehicles,
        num_pedestrians=args.walkers, buffer_frames=args.buffer,
        collect_ticks=args.collect_ticks, train_steps_per_chunk=args.train_per_chunk,
        total_train_steps=args.steps, seed=args.seed, settle_fraction=args.settle_fraction,
        mesh=mesh, device=dev)
    if not is_coordinator():
        return out
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
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
