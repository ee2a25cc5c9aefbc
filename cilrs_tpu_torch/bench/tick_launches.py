"""Kernels a simulator tick launches on the card, and their device time.

    PYTHONPATH=CHECKOUT python cilrs_tpu_torch/bench/tick_launches.py [--ticks 20] [--out F]

Profiles ``--ticks`` ticks of the collect fleet at ``cli.collect``'s full
width (Town01, 16 envs, 12 vehicles, 6 walkers) and of the benchmark
protocol's drive run (Town01, 249 -> 219, 40 vehicles, 5 walkers, the
full-width CILRS in bf16, random weights) under ``torch.profiler``, after a
warm-up chunk each, and prints the device activities (kernels and copies)
and device ms a tick. It imports the package from ``PYTHONPATH``, so one
copy of the script counts the tick of any checkout: two trees compared in
one call. Nothing here runs without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def _profile(fn, ticks: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: cuDNN's algorithms, cached constants, built kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return {"ticks": ticks,
            "device_activities_per_tick": sum(e.count for e in kernels) / ticks,
            "device_ms_per_tick": sum(e.self_device_time_total for e in kernels) / 1e3 / ticks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tick_launches: no CUDA device", file=sys.stderr)
        return 2
    import cilrs_tpu_torch
    from cilrs_tpu_torch.cli import drive as drive_cli
    from cilrs_tpu_torch.data.collect import make_collect_fleet
    from cilrs_tpu_torch.maps.town import make_town01

    dev = torch.device("cuda")
    torch.manual_seed(0)
    fleet = make_collect_fleet(make_town01(), 16, 12, 6, seed=0, chunk_steps=args.ticks,
                               device=dev)
    run, _ = drive_cli.make_drive_run(make_town01(), 249, 219, 40, 5, "clear", seed=0,
                                      device=dev)
    out = {"package": cilrs_tpu_torch.__file__, "device": torch.cuda.get_device_name(0),
           "collect_tick": _profile(fleet.chunk, args.ticks),
           "drive_tick": _profile(lambda: run.chunk(args.ticks), args.ticks)}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
