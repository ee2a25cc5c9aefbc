"""Data-collection CLI (collect_data.py parity, batched on the card).

    python -m cilrs_tpu_torch.cli.collect --frames 20000 --weather clear \
        --out data/session_001 --envs 16 --vehicles 12 --walkers 6 [--device cpu]

Writes a session directory (measurements.csv, aux.csv, npz shards,
summary.txt) that ``cli.train`` and ``cli.report`` read.
"""

from __future__ import annotations

import argparse

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import WEATHER_NAMES, weather_index
from cilrs_tpu_torch.data.collect import collect_session


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS fleet data collection (PyTorch/CUDA)")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=20000)
    p.add_argument("--weather", default="clear", choices=list(WEATHER_NAMES))
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--vehicles", type=int, default=12)
    p.add_argument("--walkers", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--map", default="town01")
    p.add_argument("--format", default="npz", choices=["npz", "jpeg"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map(args.map)
    stats = collect_session(
        net, args.out, num_frames=args.frames, num_envs=args.envs,
        num_vehicles=args.vehicles, num_pedestrians=args.walkers,
        weather_idx=weather_index(args.weather), seed=args.seed,
        image_format=args.format, device=dev,
    )
    print(f"\nDone: {stats['frames']} frames at {stats['frames_per_sec']:.0f} frames/s")
    print(f"Command distribution: {stats['command_distribution']}")
    return stats


if __name__ == "__main__":
    main()
