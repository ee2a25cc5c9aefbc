"""What the training-arm tools share (``exp_seed_arms``, ``exp_row_region``,
``exp_size_bisect``, ``exp_stage2``, ``exp_noeval_train``): one resident
collection (Town01, 16 envs, 12 vehicles, 6 walkers, mixed weather), the
train config with the arm's epochs, and ``train.loop.train`` from the table
once an arm, as the JAX tools call ``cilrs_tpu/train/loop.py:train``. Every
train batch reaches the model through the row-gather kernel."""

from __future__ import annotations

import time
from dataclasses import replace

from cilrs_tpu_torch.cli.common import build_map
from cilrs_tpu_torch.config import TrainConfig, load_train_config
from cilrs_tpu_torch.data.dataset import DriveDataset
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
from cilrs_tpu_torch.train.loop import train


def collect_for_arms(frames: int, epochs: int, seed: int, dev) -> tuple[dict, DriveDataset,
                                                                        TrainConfig]:
    """(table, host labels as a dataset, config) of ``frames`` frames
    collected from ``seed``; the config's epochs set to ``epochs``."""
    table, labels, _ = collect_resident(
        build_map("town01"), frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=seed, device=dev)
    cfg = load_train_config()
    cfg = replace(cfg, training=replace(cfg.training, epochs=epochs))
    return table, labels_dataset(labels), cfg


def train_arm(ds: DriveDataset, cfg: TrainConfig, table: dict, dev, **kwargs) -> dict:
    """One ``train`` run from the resident table with the arm's arguments."""
    return train(ds, cfg, device=dev, verbose=True, resident=dict(table), **kwargs)


def run_arm(name: str, ds: DriveDataset, cfg: TrainConfig, table: dict, dev, **kwargs) -> dict:
    """An arm's run and its result: best val loss, the last epoch's turn
    errors, the history and the wall; printed as the JAX tools print it."""
    print(f"=== arm {name} ===", flush=True)
    t0 = time.time()
    res = train_arm(ds, cfg, table, dev, **kwargs)
    h = res["history"]
    out = {
        "best_val": res["best_val_loss"],
        "left_err_last": h[-1]["steer_err_LEFT"],
        "right_err_last": h[-1]["steer_err_RIGHT"],
        "history": h,
        "wall_s": time.time() - t0,
    }
    print(f"arm {name}: best_val {res['best_val_loss']:.4f} "
          f"LEFT {h[-1]['steer_err_LEFT']:.4f} "
          f"RIGHT {h[-1]['steer_err_RIGHT']:.4f}", flush=True)
    return out
