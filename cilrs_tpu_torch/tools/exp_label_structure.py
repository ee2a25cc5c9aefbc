"""Per-region label-structure analysis of a 176k collection (port of
``tools/exp_label_structure.py``): why do late rows train worse when they
are predictable?

Measures, for early (<80k) / mid (80-150k) / tail (>=150k) row regions, per
command:
  - frame counts and |steer| distribution (creep spike at |steer|<0.02?)
  - distinct turn-arc count + mean arc length/speed (redundancy/coverage)
  - arc start-position diversity (unique 10 m cells — junction coverage)
  - mean obstacle distance + fraction queued (obstacle < 12 m)

It reads labels only; the frames stay on the card.

    python -m cilrs_tpu_torch.tools.exp_label_structure [--frames 176256 --seed 0]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.data.resident import collect_resident

COMMANDS = ["FOLLOW", "LEFT", "RIGHT", "STRAIGHT"]


def row_regions(n: int) -> dict:
    rows = np.arange(n)
    return {
        "early_<80k": rows < 80_000,
        "mid_80-150k": (rows >= 80_000) & (rows < 150_000),
        "tail_>=150k": rows >= 150_000,
    }


def arc_stats(steer, speed, pos, env, tick, sel):
    """Contiguous |steer|>0.05 runs (gap<=5 ticks) per env within `sel`."""
    arcs = []
    for e in np.unique(env[sel]):
        m = sel & (env == e)
        t = tick[m]
        s = steer[m]
        v = speed[m]
        xy = pos[m]
        order = np.argsort(t, kind="stable")
        t, s, v, xy = t[order], s[order], v[order], xy[order]
        on = np.abs(s) > 0.05
        start = None
        last_on = None
        for i in range(len(t)):
            if on[i]:
                if start is None or (last_on is not None and t[i] - t[last_on] > 5):
                    if start is not None:
                        arcs.append((e, t[start], t[last_on],
                                     float(np.mean(np.abs(s[start:last_on + 1]))),
                                     float(np.mean(v[start:last_on + 1])),
                                     xy[start]))
                    start = i
                last_on = i
        if start is not None and last_on is not None:
            arcs.append((e, t[start], t[last_on],
                         float(np.mean(np.abs(s[start:last_on + 1]))),
                         float(np.mean(v[start:last_on + 1])), xy[start]))
    arcs = [a for a in arcs if a[2] - a[1] >= 3]  # >=3 ticks
    if not arcs:
        return {"count": 0}
    cells = {(int(a[5][0] // 10), int(a[5][1] // 10)) for a in arcs}
    return {
        "count": len(arcs),
        "mean_len_ticks": float(np.mean([a[2] - a[1] + 1 for a in arcs])),
        "mean_abs_steer": float(np.mean([a[3] for a in arcs])),
        "mean_speed_kmh": float(np.mean([a[4] for a in arcs])),
        "unique_start_cells_10m": len(cells),
    }


def _f(v, spec: str) -> str:
    """``v`` formatted, or "-" for a command with no rows in the region (the
    JAX tool stops there)."""
    return "-" if v is None else format(v, spec)


def label_structure(labels: dict) -> dict:
    """The region x command table and each region's turn arcs, from the
    host labels of ``collect_resident``; printed as the JAX tool prints it."""
    steer = labels["controls"][:, 0]
    cmd = labels["command"]
    spd = labels["speed_kmh"]
    pos = labels["pos"]
    env = labels["env"]
    tick = labels["tick"]
    od = labels["obstacle_dist"]
    out = {}
    for name, sel in row_regions(len(cmd)).items():
        r = {"rows": int(sel.sum())}
        for c, cn in enumerate(COMMANDS):
            m = sel & (cmd == c)
            a = np.abs(steer[m])
            r[cn] = {
                "n": int(m.sum()),
                "frac_creep_steer<0.02": float(np.mean(a < 0.02)) if m.any() else None,
                "frac_arc_steer>0.1": float(np.mean(a > 0.1)) if m.any() else None,
                "mean_abs_steer": float(a.mean()) if m.any() else None,
                "mean_speed_kmh": float(spd[m].mean()) if m.any() else None,
                "frac_queued_obs<12m": float(np.mean(od[m] < 12.0)) if m.any() else None,
            }
        turn_sel = sel & ((cmd == 1) | (cmd == 2))
        r["turn_arcs"] = arc_stats(steer, spd, pos, env, tick, turn_sel)
        out[name] = r
        print(f"\n== {name} ({r['rows']} rows) ==")
        for cn in ["LEFT", "RIGHT"]:
            d = r[cn]
            print(f"  {cn}: n={d['n']} creep<.02={_f(d['frac_creep_steer<0.02'], '.2f')} "
                  f"arc>.1={_f(d['frac_arc_steer>0.1'], '.2f')} "
                  f"|steer|={_f(d['mean_abs_steer'], '.3f')} v={_f(d['mean_speed_kmh'], '.1f')} "
                  f"queued={_f(d['frac_queued_obs<12m'], '.2f')}")
        print(f"  arcs: {r['turn_arcs']}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=176_256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/label_structure.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    net = build_map("town01")
    _, labels, _ = collect_resident(
        net, args.frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=args.seed, device=dev)
    out = label_structure(labels)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return out


if __name__ == "__main__":
    main()
