"""What the training-arm tools share (``exp_seed_arms``, ``exp_row_region``,
``exp_size_bisect``, ``exp_stage2``, ``exp_noeval_train``, ``exp_band_arms``,
``exp_big_table_control``, ``exp_200k_bisect``, ``exp_tail_poison``): one
resident collection (Town01, 16 envs, 12 vehicles, 6 walkers, mixed
weather), the train config with the arm's epochs, ``train.loop.train`` from
the table once an arm, as the JAX tools call ``cilrs_tpu/train/loop.py:train``,
and an arm's offline reports: its best weights on rows of a table, and on a
fresh 33,000-frame holdout that no training collection used. Every train
batch and every scored frame reaches the model through the row-gather
kernel."""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import build_map
from cilrs_tpu_torch.config import TrainConfig, load_train_config
from cilrs_tpu_torch.data.dataset import DriveDataset
from cilrs_tpu_torch.data.resident import collect_resident, labels_dataset
from cilrs_tpu_torch.evaluation.report import (collect_predictions_resident, offline_report,
                                               save_report)
from cilrs_tpu_torch.train.checkpoint import restore_best_params
from cilrs_tpu_torch.train.loop import train
from cilrs_tpu_torch.train.state import create_train_state

FRESH_FRAMES = 33_000  # the fresh holdout: 1.74 GB, one page
FRESH_SEED_OFFSET = 777_777


def with_epochs(cfg: TrainConfig, epochs: int) -> TrainConfig:
    return replace(cfg, training=replace(cfg.training, epochs=epochs))


def collect_for_arms(frames: int, epochs: int, seed: int, dev) -> tuple[dict, DriveDataset,
                                                                        TrainConfig]:
    """(table, host labels as a dataset, config) of ``frames`` frames
    collected from ``seed``; the config's epochs set to ``epochs``."""
    table, labels, _ = collect_resident(
        build_map("town01"), frames, num_envs=16, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=seed, device=dev)
    return table, labels_dataset(labels), with_epochs(load_train_config(), epochs)


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


def best_model(cfg: TrainConfig, ckpt_dir: str, dev) -> torch.nn.Module:
    """The best slot of an arm's checkpoints in a model of ``cfg``, in eval
    mode."""
    state = restore_best_params(ckpt_dir, create_train_state(cfg, 0, device=dev))
    return state.model.eval()


def report_rows(model: torch.nn.Module, table: dict, labels: dict, rows: np.ndarray,
                cfg: TrainConfig, path: str) -> dict:
    """The offline report of ``model`` on global rows ``rows`` of ``table``
    (weather e % 5 of each row's env), saved to ``path``; its steer MAE
    printed, overall and by command."""
    lab = {k: labels[k] for k in ("controls", "speed", "command")}
    pred, true, cmd = collect_predictions_resident(model, table, lab, rows,
                                                   cfg.training.batch_size, cfg)
    rep = offline_report(pred, true, cmd, weather=labels["env"][rows] % 5)
    save_report(rep, path)
    print(f"  ({len(rows)} rows): steer MAE {rep['steer']['mae']:.4f} "
          f"within0.01 {rep['steer_accuracy']['within_0.01']:.3f}")
    for c, v in rep["per_command"].items():
        print(f"    {c:>10}: steer MAE {v['steer_mae']:.4f} ({v['samples']})")
    return rep


def fresh_holdout(net, model: torch.nn.Module, cfg: TrainConfig, envs: int, seed: int, dev,
                  path: str) -> dict:
    """The report of ``model`` on every frame of a fresh 33,000-frame
    collection seeded ``seed + 777,777``, a table no training touched."""
    table, labels, _ = collect_resident(
        net, FRESH_FRAMES, num_envs=envs, num_vehicles=12, num_pedestrians=6,
        weather_idx=None, seed=seed + FRESH_SEED_OFFSET, device=dev)
    print("  fresh holdout", end="")
    return report_rows(model, table, labels, np.arange(FRESH_FRAMES), cfg, path)
