"""Teacher label-noise floor: the irreducible behavior-cloning error (port of
``tools/label_noise_floor.py``).

A BC model predicting y from observation x can at best achieve
E[ |y - E[y|x]| ]; if the teacher emits different labels from (nearly) the
same state, that variance is unlearnable. We estimate it from collected
sessions by pairing frames whose STATE matches (same command, position within
`pos_tol` m, heading within `yaw_tol` deg, speed within `speed_tol` km/h —
i.e. states that render to near-identical camera frames) and measuring the
mean absolute label difference within pairs. Half the expected |y1-y2| of
matched pairs estimates the MAE floor (for symmetric noise).

    python -m cilrs_tpu_torch.tools.label_noise_floor data/session_* [--pos-tol 0.75]

The sessions are read with ``csv`` and numpy into a dict of columns typed as
pandas' reader types them (int64, float64, else str); the analysis is on the
host. ``--device`` (default ``cuda``) is the port's, as every entry point's.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
from collections import defaultdict

import numpy as np

from cilrs_tpu_torch.cli.common import require_cuda

CONTROLS = ("steer", "throttle", "brake")


def _column(values: list) -> np.ndarray:
    """One CSV column: int64 when every value is an integer, else float64,
    else str."""
    for cast, dtype in ((int, np.int64), (float, np.float64)):
        try:
            return np.array([cast(v) for v in values], dtype=dtype)
        except ValueError:
            pass
    return np.array(values, dtype=object)


def read_csv(path: str) -> dict:
    """A CSV file as {column: numpy array}, in the file's column order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _column([r[k] for r in body]) for k, name in enumerate(header)}


def num_rows(df: dict) -> int:
    return len(next(iter(df.values())))


def load_sessions(paths) -> dict:
    """The sessions' measurements.csv rows, concatenated, with ``session``
    (the path) and, where the session has aux.csv, ``obstacle_dist`` and
    ``tl_state``, plus ``env`` and ``tick`` when aux.csv has them (resident
    sessions). A column some sessions lack is NaN in their rows."""
    dfs = []
    for p in paths:
        path = os.path.join(p, "measurements.csv")
        if os.path.exists(path):
            df = read_csv(path)
            df["session"] = np.array([p] * num_rows(df), dtype=object)
            aux = os.path.join(p, "aux.csv")
            if os.path.exists(aux):
                a = read_csv(aux)
                df["obstacle_dist"] = a["obstacle_dist"]
                df["tl_state"] = a["tl_state"]
                if "env" in a:  # resident sessions interleave envs
                    df["env"] = a["env"]
                    df["tick"] = a["tick"]
            dfs.append(df)
    if not dfs:
        sys.exit("no measurements.csv found in given paths")
    names = list(dict.fromkeys(k for df in dfs for k in df))
    return {k: np.concatenate([df[k] if k in df else np.full(num_rows(df), np.nan)
                               for df in dfs]) for k in names}


def match_pairs(df: dict, pos_tol=0.75, yaw_tol=3.0, speed_tol=1.5, max_pairs=200_000):
    """Greedy spatial-hash matching of near-identical states across frames:
    the JAX tool's pairs, in its order (buckets in the lexsort order of their
    cells, each compared with itself and its +x, +y and +xy neighbours)."""
    pos = np.stack([df["position_x"], df["position_y"]], axis=1)
    yaw = df["yaw"]
    spd = df["speed_kmh"]
    cmd = df["high_level_command"]
    frame = df["frame"]
    sess = df["session"]
    # Gating context (from aux.csv when available): the teacher's throttle and
    # brake condition on obstacle distance and traffic-light state, both of
    # which are observable in the rendered frame; two states only count as
    # "the same" if their gating context matches too.
    has_aux = "obstacle_dist" in df
    if has_aux:
        od = df["obstacle_dist"]
        tl = df["tl_state"]
        od_far = od > 25.0  # beyond any teacher gate at <=30 km/h
    # Resident sessions interleave envs in row order: "the same pass through a
    # state" is same env + nearby tick, not a nearby CSV row.
    has_env = "env" in df
    if has_env:
        env = df["env"]
        tick = df["tick"]

    keys = np.floor(pos / pos_tol).astype(np.int64)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    pairs = []
    buckets = defaultdict(list)
    for i in order:
        buckets[(keys[i, 0], keys[i, 1])].append(i)
    for (kx, ky), idxs in buckets.items():
        cand = list(idxs)
        for nb in ((kx + 1, ky), (kx, ky + 1), (kx + 1, ky + 1)):
            cand += buckets.get(nb, [])
        for a_pos, i in enumerate(idxs):
            for j in cand[a_pos + 1:]:
                if cmd[i] != cmd[j]:
                    continue
                # Same session and the same pass through this state (labels
                # trivially autocorrelated): excluded.
                if sess[i] == sess[j]:
                    if has_env:
                        if env[i] == env[j] and abs(int(tick[i]) - int(tick[j])) < 50:
                            continue
                    elif abs(int(frame[i]) - int(frame[j])) < 50:
                        continue
                if np.hypot(*(pos[i] - pos[j])) > pos_tol:
                    continue
                dyaw = abs((yaw[i] - yaw[j] + 180.0) % 360.0 - 180.0)
                if dyaw > yaw_tol or abs(spd[i] - spd[j]) > speed_tol:
                    continue
                if has_aux:
                    if tl[i] != tl[j]:
                        continue
                    if not (od_far[i] and od_far[j]) and abs(od[i] - od[j]) > 1.0:
                        continue
                pairs.append((i, j))
                if len(pairs) >= max_pairs:
                    return np.asarray(pairs)
    return np.asarray(pairs) if pairs else np.zeros((0, 2), np.int64)


def labels_of(df: dict) -> np.ndarray:
    """[N, 3] steer, throttle, brake."""
    return np.stack([df[k] for k in CONTROLS], axis=1)


def matched_sessions(patterns, pos_tol: float, yaw_tol: float, speed_tol: float):
    """(columns, pairs, counts) of the sessions the glob ``patterns`` name;
    prints the counts as the JAX tools print them."""
    paths = []
    for s in patterns:
        paths += glob.glob(s)
    df = load_sessions(paths)
    print(f"{num_rows(df)} frames from {len(paths)} sessions")
    pairs = match_pairs(df, pos_tol, yaw_tol, speed_tol)
    print(f"{len(pairs)} matched state pairs")
    return df, pairs, {"frames": num_rows(df), "sessions": len(paths), "pairs": len(pairs)}


def noise_floors(labels: np.ndarray, pairs: np.ndarray) -> dict:
    """Per-control MAE floors (E|y1 - y2| / 2) over all pairs and split by
    |steer| > 0.1, and the controls' loss floor; printed as the JAX tool
    prints them."""
    d = np.abs(labels[pairs[:, 0]] - labels[pairs[:, 1]])
    steer_mag = np.maximum(np.abs(labels[pairs[:, 0], 0]), np.abs(labels[pairs[:, 1], 0]))
    big = steer_mag > 0.1
    floors = {}

    def report(tag, sel):
        if sel.sum() == 0:
            print(f"  {tag}: no pairs")
            floors[tag] = None
            return
        m = d[sel].mean(axis=0) / 2.0  # E|y1-y2|/2 ~ MAE floor
        floors[tag] = {"pairs": int(sel.sum()), "steer_floor": float(m[0]),
                       "throttle_floor": float(m[1]), "brake_floor": float(m[2])}
        print(f"  {tag:24s} pairs={int(sel.sum()):7d}  "
              f"steer_floor={m[0]:.4f}  throttle_floor={m[1]:.4f}  "
              f"brake_floor={m[2]:.4f}")

    print("\nestimated per-control BC noise floors (MAE):")
    report("all pairs", np.ones(len(pairs), bool))
    report("big-steer (|s|>0.1)", big)
    report("small-steer", ~big)
    # Loss floor: the 5*L1(steer)+L1(thr)+L1(brk) part of the CILRS loss.
    m = d.mean(axis=0) / 2.0
    loss_floor = float(5 * m[0] + m[1] + m[2])
    print(f"\ncontrols loss floor = 5*{m[0]:.4f} + {m[1]:.4f} + {m[2]:.4f} "
          f"= {loss_floor:.4f}")
    return {"floors": floors, "controls_loss_floor": loss_floor}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("sessions", nargs="+")
    p.add_argument("--pos-tol", type=float, default=0.75)
    p.add_argument("--yaw-tol", type=float, default=3.0)
    p.add_argument("--speed-tol", type=float, default=1.5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    require_cuda(args.device)

    df, pairs, out = matched_sessions(args.sessions, args.pos_tol, args.yaw_tol, args.speed_tol)
    if len(pairs) == 0:
        return out
    out.update(noise_floors(labels_of(df), pairs))
    return out


if __name__ == "__main__":
    main()
