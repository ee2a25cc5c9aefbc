"""Training CLI (notebook PARTs A-E as a command).

    python -m cilrs_tpu_torch.cli.train --data data/session_001 [data/session_002 ...] \
        --ckpt-dir runs/cilrs --epochs 20 [--resume] [--device cpu]
    torchrun --nproc_per_node N -m cilrs_tpu_torch.cli.train --data ... --ckpt-dir runs/cilrs

Loads the sessions, ships the train split and a val subset to the card once,
and trains there (``train.loop.train``); the best slot,
``<ckpt-dir>/checkpoint_best.pth``, is what ``cli.report --checkpoint`` reads.
Under torchrun with more than one rank, each rank trains on its block of
every host batch (``train.loop``'s data-parallel branch) and rank 0 writes
the checkpoints; a world of 1 keeps the card-resident path.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.dataset import load_sessions
from cilrs_tpu_torch.parallel.distributed import initialize_distributed, is_coordinator
from cilrs_tpu_torch.parallel.mesh import make_mesh
from cilrs_tpu_torch.train.loop import train


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS training (PyTorch/CUDA)")
    p.add_argument("--data", nargs="+", required=True, help="session directories")
    p.add_argument("--ckpt-dir", default="runs/cilrs")
    p.add_argument("--config", default=None, help="path to train.json override")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--hard-boost", type=float, default=None,
                   help="extra sampling weight on big-steer/brake frames "
                        "(0 = reference-parity command weighting)")
    p.add_argument("--pretrained-backbone", default=None,
                   help="torchvision resnet34 state_dict .pth to init the trunk "
                        "(reference notebook PART B uses ImageNet weights)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)
    # The process group first: it sets this rank's GPU before any CUDA work.
    mesh = make_mesh(device=dev.type) if initialize_distributed(device=dev) else None
    if mesh is not None:
        dev = mesh.device
    say = print if is_coordinator() else (lambda *a, **k: None)

    cfg = load_train_config(args.config)
    tcfg = cfg.training
    if args.epochs is not None:
        tcfg = dataclasses.replace(tcfg, epochs=args.epochs)
    if args.batch_size is not None:
        tcfg = dataclasses.replace(tcfg, batch_size=args.batch_size)
    if args.hard_boost is not None:
        tcfg = dataclasses.replace(tcfg, hard_frame_boost=args.hard_boost)
    cfg = dataclasses.replace(cfg, training=tcfg)

    say(f"Loading sessions: {args.data}")
    t0 = time.time()
    ds = load_sessions(args.data)
    say(f"  {len(ds)} frames (loaded in {time.time()-t0:.0f}s)")
    t1 = time.time()
    out = train(ds, cfg, ckpt_dir=args.ckpt_dir, resume=args.resume, device=dev,
                pretrained_backbone=args.pretrained_backbone, mesh=mesh)
    say(f"\nBest val loss: {out['best_val_loss']:.4f} "
        f"(train wall {time.time()-t1:.0f}s)")
    return out


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
