"""Is the TAIL of a long collection poisoned, or does training itself break
past 150k? (port of ``tools/exp_tail_poison.py``)

Hypotheses:
  (a) tail poison: frames collected past tick ~9.4k (the 150k-frame point at
      16 envs) are bad: degraded or misaligned images, or labels that stop
      matching the scene;
  (b) training-side scaling: training against the bigger resident table
      breaks even when every TRAIN row comes from the healthy prefix.

ONE collection (seed 0, 16 envs: a frame-identical prefix of a 150k one), then
  1. image probes, no training: per-tick-band pixel statistics and a contact
     sheet of mid-turn frames early (tick < 3k) against late (tick > 11k),
     each read through the row-gather kernel;
  2. arm "prefix": trained ONLY on rows < ``--prefix-frames`` (``train``'s
     train_row_mask) against the FULL resident table;
  3. offline reports by val region: rows below the prefix and the tail; then
     a fresh 33,000-frame holdout that no training touched.

Readout: prefix healthy on early val, bad on tail val -> (a); prefix healthy
on both -> (a) but subtler (tail rows learnable alone yet poisonous when
sampled); prefix collapsed -> (b).

The contact sheet is a PNG written with zlib (the card's machine has no
matplotlib): a 2 x ``per_side`` grid of the frames, early on top, with
``SHEET_GAP`` black pixels between them; the labels the JAX figure put in
its titles are printed. The tool sets ``CILRS_TPU_ALLOW_BIG_TABLE=1`` unless
the caller set it, for the duration of ``main``.

    python -m cilrs_tpu_torch.tools.exp_tail_poison [--frames 200000 --prefix-frames 150000]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import time
import zlib

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map, require_cuda
from cilrs_tpu_torch.config import load_train_config
from cilrs_tpu_torch.data.dataset import stratified_split
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset, unwrap_monolithic
from cilrs_tpu_torch.ops.gather import gather_rows
from cilrs_tpu_torch.tools.arms import best_model, fresh_holdout, report_rows, with_epochs
from cilrs_tpu_torch.tools.exp_checksum import allow_big_table
from cilrs_tpu_torch.train.loop import train

SHEET_GAP = 2


def _frames(table: dict, rows: np.ndarray) -> np.ndarray:
    """Rows of a one-page table as host u8 [n, D], one gather launch."""
    page = table["images"]
    d = int(np.prod(table["image_shape"]))
    idx = torch.from_numpy(np.asarray(rows, dtype=np.int32)).to(page.device)
    return gather_rows(page, idx)[:, :d].cpu().numpy()


def pixel_band_stats(table, labels, bands=(0, 3000, 6000, 9000, 12000, 15000),
                     width=500, n=256):
    """Per-tick-band mean/std of raw frame bytes (detects render degradation)."""
    tick = labels["tick"]
    out = []
    for lo in bands:
        rows = np.where((tick >= lo) & (tick < lo + width))[0][:n]
        if len(rows) == 0:
            continue
        px = _frames(table, rows)
        out.append({"tick_lo": int(lo), "rows": len(rows),
                    "mean": round(float(px.mean()), 3),
                    "std": round(float(px.std()), 3),
                    "p01": int(np.percentile(px, 1)),
                    "p99": int(np.percentile(px, 99))})
    return out


def write_png(path: str, img: np.ndarray):
    """An [H, W, 3] u8 image as an 8-bit RGB PNG (one IDAT, no filter)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def turn_contact_sheet(table, labels, path, per_side=8) -> list[int]:
    """Mid-turn frames early vs late, with their labels. If late frames don't
    LOOK like mid-turn scenes, images and labels are misaligned (or the
    render degrades) past the 150k point. Returns the rows, in grid order."""
    h, w, c = table["image_shape"]
    tick = labels["tick"]
    steer = labels["controls"][:, 0]
    cmd = labels["command"]
    turn = ((cmd == 1) | (cmd == 2)) & (np.abs(steer) > 0.15)
    early = np.where(turn & (tick < 3000))[0]
    late = np.where(turn & (tick > 11000))[0]
    rng = np.random.RandomState(0)
    early = rng.choice(early, min(per_side, len(early)), replace=False)
    late = rng.choice(late, min(per_side, len(late)), replace=False)
    rows = np.concatenate([early, late]).astype(np.int64)
    px = _frames(table, rows).reshape(-1, h, w, c) if len(rows) else np.zeros((0, h, w, c))
    sheet = np.zeros((2 * h + SHEET_GAP, per_side * w + (per_side - 1) * SHEET_GAP, c), np.uint8)
    print("mid-turn frames: early ticks (top) vs late ticks (bottom)")
    for i, r in enumerate(rows):
        y, x = (i // per_side) * (h + SHEET_GAP), (i % per_side) * (w + SHEET_GAP)
        sheet[y:y + h, x:x + w] = px[i]
        print(f"  [{i // per_side},{i % per_side}] row {r} tick {tick[r]} env {labels['env'][r]} "
              f"{'LEFT' if cmd[r] == 1 else 'RIGHT'} steer {steer[r]:+.2f} "
              f"v {labels['speed_kmh'][r]:.0f}")
    write_png(path, sheet)
    return rows.tolist()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/r4f")
    p.add_argument("--frames", type=int, default=200_000)
    p.add_argument("--prefix-frames", type=int, default=150_000)
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_cuda(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    net = build_map("town01")
    with allow_big_table():
        print(f"=== collect {args.frames} frames (seed {args.seed}) ===", flush=True)
        t0 = time.time()
        table, labels, _ = collect_resident(
            net, args.frames, num_envs=args.envs, num_vehicles=12, num_pedestrians=6,
            weather_idx=None, seed=args.seed, device=dev)
        print(f"collect: {time.time() - t0:.0f}s", flush=True)

        print("\n=== image probes (zero training) ===", flush=True)
        stats = pixel_band_stats(unwrap_monolithic(table), labels)
        for row in stats:
            print(f"  {row}", flush=True)
        with open(os.path.join(args.workdir, "pixel_band_stats.json"), "w") as f:
            json.dump(stats, f, indent=2)
        sheet = os.path.join(args.workdir, "turn_frames_early_vs_late.png")
        sheet_rows = turn_contact_sheet(unwrap_monolithic(table), labels, sheet)
        print(f"  contact sheet -> {sheet}", flush=True)
        res = {"pixel_band_stats": stats, "sheet": sheet, "sheet_rows": sheet_rows}
        if args.skip_train:
            return res

        cfg = with_epochs(load_train_config(), args.epochs)
        ds = labels_dataset(labels)
        _, val_idx = stratified_split(ds, cfg.training.val_fraction, cfg.training.seed)
        mask = np.arange(len(ds)) < args.prefix_frames

        print(f"\n=== train arm prefix (rows < {args.prefix_frames}) ===", flush=True)
        t0 = time.time()
        ckpt_dir = os.path.join(args.workdir, "ckpt_prefix")
        out = train(ds, cfg, ckpt_dir=ckpt_dir, resident=table, train_row_mask=mask, device=dev)
        wall = time.time() - t0
        print(f"prefix: best val {out['best_val_loss']:.4f} in {wall:.0f}s", flush=True)
        res.update(best_val=out["best_val_loss"], wall_s=wall, reports={})

        model = best_model(cfg, ckpt_dir, dev)
        for region, vsel in (("early", val_idx[val_idx < args.prefix_frames]),
                             ("tail", val_idx[val_idx >= args.prefix_frames])):
            print(f"  val[{region}]", end="")
            res["reports"][region] = report_rows(
                model, out["val_table"], labels, np.asarray(vsel), cfg,
                os.path.join(args.workdir, f"evaluation_report_{region}.json"))

        # Fresh holdout: a table no training touched, the trusted oracle. If the
        # prefix arm scores well here while its val curves looked collapsed, the
        # curves were polluted by unpredictable tail val rows.
        table = out = None  # free the big table (out["val_table"] is it)
        res["reports"]["fresh"] = fresh_holdout(
            net, model, cfg, args.envs, args.seed, dev,
            os.path.join(args.workdir, "evaluation_report_fresh.json"))
    return res


if __name__ == "__main__":
    main()
