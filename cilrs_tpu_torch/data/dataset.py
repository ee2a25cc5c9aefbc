"""Session datasets on the host (port of ``cilrs_tpu/data/dataset.py``).

numpy code, copied so that its indices are bit-identical to the JAX package's:
session loading (measurements.csv plus npz shards or image files, with the
uncompressed ``.cache.npz`` sidecar), the seed-42 per-command stratified split,
the inverse-frequency ``command_weights`` and the ``WeightedBatchSampler`` over
them, and the synthetic dataset. ``save_session`` writes the format the
loader reads.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from cilrs_tpu_torch.config import COMMAND_NAMES, SPEED_NORM_FACTOR

COMMAND_MAP = {name: i for i, name in enumerate(COMMAND_NAMES)}
COMMAND_MAP.update({"LANEFOLLOW": 0, "FOLLOW": 0, "LEFT": 1, "RIGHT": 2, "STRAIGHT": 3})

# The reference's 14-column measurements.csv schema (collect_data.py:549-564).
CSV_HEADER = [
    "frame", "image_filename", "steer", "throttle", "brake", "speed_kmh",
    "speed_normalized", "high_level_command", "command_name",
    "position_x", "position_y", "position_z", "yaw", "timestamp",
]


@dataclass
class DriveDataset:
    images: np.ndarray  # [N, H, W, 3] uint8
    speed_norm: np.ndarray  # [N] f32
    command: np.ndarray  # [N] i32
    controls: np.ndarray  # [N, 3] f32 (steer, throttle, brake)

    def __len__(self):
        return len(self.command)


def _load_one_session(d: str):
    with open(os.path.join(d, "measurements.csv")) as f:
        rows = list(csv.DictReader(f))
    imgs, speeds, cmds, ctls = [], [], [], []
    shard_cache: dict[str, np.ndarray] = {}
    for row in rows:
        fn = row["image_filename"]
        if "#" in fn:  # npz shard reference
            shard, k = fn.split("#")
            if shard not in shard_cache:
                shard_cache[shard] = np.load(os.path.join(d, shard))["frames"]
            imgs.append(shard_cache[shard][int(k)])
        else:
            from PIL import Image

            imgs.append(np.asarray(Image.open(os.path.join(d, fn))))
        speeds.append(float(row["speed_normalized"]))
        cmds.append(COMMAND_MAP.get(row["command_name"].upper(), int(row["high_level_command"])))
        ctls.append([float(row["steer"]), float(row["throttle"]), float(row["brake"])])
    return (np.stack(imgs), np.asarray(speeds, np.float32),
            np.asarray(cmds, np.int32), np.asarray(ctls, np.float32))


def load_sessions(session_dirs: list[str], cache: bool = True) -> DriveDataset:
    """Load one or more session dirs (npz or jpeg format).

    On first load each session is mirrored into an UNCOMPRESSED `.cache.npz`
    sidecar, which later loads read at disk speed instead of inflating every
    shard again. Delete the sidecar after re-collecting.
    """
    imgs, speeds, cmds, ctls = [], [], [], []
    for d in session_dirs:
        cpath = os.path.join(d, ".cache.npz")
        if cache and os.path.exists(cpath) and (
                os.path.getmtime(cpath) >=
                os.path.getmtime(os.path.join(d, "measurements.csv"))):
            z = np.load(cpath)
            part = (z["images"], z["speed"], z["command"], z["controls"])
        else:
            part = _load_one_session(d)
            if cache:
                tmp = cpath + ".tmp.npz"
                np.savez(tmp, images=part[0], speed=part[1],
                         command=part[2], controls=part[3])
                os.replace(tmp, cpath)
        imgs.append(part[0])
        speeds.append(part[1])
        cmds.append(part[2])
        ctls.append(part[3])
    return DriveDataset(
        images=np.concatenate(imgs) if len(imgs) > 1 else imgs[0],
        speed_norm=np.concatenate(speeds),
        command=np.concatenate(cmds),
        controls=np.concatenate(ctls),
    )


def save_session(d: str, ds: DriveDataset, shard_size: int = 1000):
    """Write ``ds`` as a session dir that ``load_sessions`` reads: uncompressed
    ``frames_XXXX.npz`` shards and a 14-column measurements.csv (speed in km/h
    derived from the normalized speed; positions, yaw and timestamp zero)."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "measurements.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_HEADER)
        for shard_id, s in enumerate(range(0, len(ds), shard_size)):
            shard_name = f"frames_{shard_id:04d}.npz"
            np.savez(os.path.join(d, shard_name), frames=ds.images[s:s + shard_size])
            for k in range(min(shard_size, len(ds) - s)):
                i = s + k
                c = int(ds.command[i])
                writer.writerow([
                    i, f"{shard_name}#{k}",
                    f"{ds.controls[i, 0]:.6f}", f"{ds.controls[i, 1]:.6f}",
                    f"{ds.controls[i, 2]:.6f}",
                    f"{ds.speed_norm[i] * SPEED_NORM_FACTOR:.3f}", f"{ds.speed_norm[i]:.6f}",
                    c, COMMAND_NAMES[c], "0.000", "0.000", "0.000", "0.000", "0.000",
                ])


def stratified_split(ds: DriveDataset, val_fraction: float = 0.15, seed: int = 42):
    """Per-command stratified split (notebook PART A uses sklearn with seed 42)."""
    rng = np.random.RandomState(seed)
    train_idx, val_idx = [], []
    for c in range(4):
        idx = np.nonzero(ds.command == c)[0]
        rng.shuffle(idx)
        n_val = int(round(len(idx) * val_fraction))
        val_idx.append(idx[:n_val])
        train_idx.append(idx[n_val:])
    return np.concatenate(train_idx), np.concatenate(val_idx)


def command_weights(
    command: np.ndarray,
    controls: np.ndarray | None = None,
    hard_boost: float = 0.0,
) -> np.ndarray:
    """Inverse-frequency per-sample weights (WeightedRandomSampler parity).

    With hard_boost > 0, big-steer (|steer| > 0.1) and braking (brake > 0.05)
    frames additionally get (1 + boost)x weight. The reference's sampler is
    command-only (boost 0).
    """
    counts = np.bincount(command, minlength=4).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    w = (1.0 / counts)[command]
    if controls is not None and hard_boost > 0.0:
        hard = (np.abs(controls[:, 0]) > 0.1) | (controls[:, 2] > 0.05)
        w = w * (1.0 + hard_boost * hard)
    return (w / w.sum()).astype(np.float64)


class WeightedBatchSampler:
    """Oversampling batch index generator matching WeightedRandomSampler
    (with replacement, weighted by inverse command frequency)."""

    def __init__(self, command: np.ndarray, batch_size: int, seed: int = 42,
                 controls: np.ndarray | None = None, hard_boost: float = 0.0):
        self.p = command_weights(command, controls, hard_boost)
        self.n = len(command)
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)

    def __call__(self) -> np.ndarray:
        return self.rng.choice(self.n, size=self.batch_size, replace=True, p=self.p)

    def epoch(self, steps: int):
        # One vectorized draw per epoch: np.random.choice with `p` rebuilds
        # the CDF on every call.
        idx = self.rng.choice(self.n, size=steps * self.batch_size,
                              replace=True, p=self.p)
        yield from idx.reshape(steps, self.batch_size)


def make_synthetic_dataset(n: int = 512, seed: int = 0, h: int = 88, w: int = 200) -> DriveDataset:
    """Small random dataset for tests/benchmarks (no collection required)."""
    rng = np.random.RandomState(seed)
    return DriveDataset(
        images=rng.randint(0, 256, (n, h, w, 3), dtype=np.uint8),
        speed_norm=rng.uniform(0, 0.5, n).astype(np.float32),
        command=rng.randint(0, 4, n).astype(np.int32),
        controls=np.stack([
            rng.uniform(-0.3, 0.3, n),
            rng.uniform(0, 0.8, n),
            (rng.uniform(0, 1, n) < 0.1) * rng.uniform(0, 1, n),
        ], axis=1).astype(np.float32),
    )
