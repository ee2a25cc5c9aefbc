"""5-weather closed-loop benchmark -> markdown report (port of
``cilrs_tpu/cli/benchmark.py``).

The JAX package's evaluation protocol: for each of clear/rain/fog/night/
hardrain, one ``cli.drive`` run spawn -> destination with NPC traffic, scored
with Safety*0.6 + Comfort*0.3 + Route*0.1, then a table of the runs:

    python -m cilrs_tpu_torch.cli.benchmark --checkpoint runs/cilrs --out RESULTS.md \\
        [--json-out benchmark.json] [--events-dir events/] [--device cpu]

The defaults are the JAX package's: spawn 249 -> destination 219 (the longest
spawn-pair route of Town01, 1,285 m), 40 vehicles, 5 pedestrians, a 600 s cap.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from cilrs_tpu_torch.cli import drive as drive_cli
from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.config import WEATHER_NAMES

WEATHER_LABELS = {
    "clear": "Clear", "rain": "Rain", "fog": "Fog",
    "night": "Night", "hardrain": "Hard Rain",
}


def main(argv=None):
    p = argparse.ArgumentParser(description="CILRS 5-weather benchmark (PyTorch/CUDA)")
    p.add_argument("--checkpoint", default=None)
    # The cap is pro-rata to the route: the reference caps ~0.5 km routes at
    # 289-384 s; 600 s for 1,285 m is stricter than that.
    p.add_argument("--duration", type=float, default=600.0)
    p.add_argument("--spawn", type=int, default=249)
    p.add_argument("--destination", type=int, default=219)
    p.add_argument("--vehicles", type=int, default=40)
    p.add_argument("--pedestrians", type=int, default=5)
    p.add_argument("--map", default="town01")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="RESULTS_torch.md")
    p.add_argument("--json-out", default=None)
    p.add_argument("--autopilot", action="store_true")
    p.add_argument("--weathers", nargs="*", default=list(WEATHER_NAMES))
    p.add_argument("--events-dir", default=None,
                   help="write per-weather rescue/collision event JSONs here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    require_cuda(args.device)
    if args.events_dir:
        os.makedirs(args.events_dir, exist_ok=True)

    results = {}
    for weather in args.weathers:
        print(f"\n===== {weather} =====")
        drive_args = [
            "--duration", str(args.duration), "--spawn", str(args.spawn),
            "--destination", str(args.destination),
            "--vehicles", str(args.vehicles),
            "--pedestrians", str(args.pedestrians),
            "--weather", weather, "--map", args.map, "--seed", str(args.seed),
            "--no-hud", "--device", args.device,
        ]
        if args.autopilot:
            drive_args.append("--autopilot")
        elif args.checkpoint:
            drive_args += ["--checkpoint", args.checkpoint]
        if args.events_dir:
            drive_args += ["--events-json", os.path.join(args.events_dir, f"events_{weather}.json")]
        results[weather] = drive_cli.main(drive_args)

    md = format_markdown(results, args)
    with open(args.out, "w") as f:
        f.write(md)
    print(f"\nbenchmark report -> {args.out}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    return results


def format_markdown(results: dict, args) -> str:
    rows = []
    total = collisions = teleports = recoveries = 0.0
    completed = 0
    for w, s in results.items():
        rows.append(
            f"| {WEATHER_LABELS.get(w, w)} | {s['overall']:.1f} | {s['grade'].split()[0]} | "
            f"{s['collisions']:.0f} | {'yes' if s['routes_completed'] >= 1 else 'no'} | "
            f"{s.get('teleports', 0):.0f} | {s.get('recoveries', 0):.0f} | "
            f"{s.get('route_length_m', float('nan')):.0f} m | "
            f"{s['total_time_s']:.0f} s | {s['max_speed_kmh']:.1f} km/h |"
        )
        total += s["overall"]
        collisions += s["collisions"]
        teleports += s.get("teleports", 0)
        recoveries += s.get("recoveries", 0)
        completed += int(s["routes_completed"] >= 1)
    avg = total / max(len(results), 1)
    return "\n".join([
        "# CILRS-TPU 5-Weather Closed-Loop Benchmark",
        "",
        f"Protocol: spawn {args.spawn} -> destination {args.destination}, "
        f"{args.vehicles} NPC vehicles, {args.pedestrians} pedestrians, map {args.map}, "
        f"20 Hz, duration cap {args.duration:.0f} s. "
        f"Policy: {'rule-based autopilot' if args.autopilot else args.checkpoint or 'untrained'}.",
        "",
        # Teleports and recoveries are rescues the scoring formula cannot see.
        "| Weather | Overall | Grade | Collisions | Destination | Teleports | Recoveries | Route | Time | Max speed |",
        "|---------|---------|-------|------------|-------------|-----------|------------|-------|------|-----------|",
        *rows,
        "",
        f"**Average score: {avg:.1f} / 100 — {collisions:.0f} total collisions — "
        f"{completed}/{len(results)} destinations reached — "
        f"{teleports:.0f} teleports, {recoveries:.0f} recoveries.**",
        "",
        f"_Scoring: Safety x0.6 + Comfort x0.3 + Route x0.1 "
        f"(reference formula, model/autonomous_drive.py:93-155). Generated {time.strftime('%Y-%m-%d %H:%M')}._",
    ])


if __name__ == "__main__":
    main()
