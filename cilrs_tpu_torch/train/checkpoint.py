"""Checkpoints: notebook-format ``.pth`` files with training resume.

Every slot file is the notebook's ``{"model_state_dict", "epoch", "val_loss"}``
dict (what the reference's training notebook writes and ``load_policy``
reads) plus ``speed_skip`` and the caller's extras. The slots mirror the JAX
package's Orbax ones (``cilrs_tpu/train/checkpoint.py``):

 - ``<ckpt_dir>/checkpoint_best.pth``: the single best slot, the deployment
   artifact (``load_policy`` and ``cli.report`` read it as it is), with
   ``best_epoch.txt`` beside it;
 - ``<ckpt_dir>/latest/checkpoint_epoch_NNNN.pth``: the rolling resume slot,
   the newest 3 kept, which also holds ``step``, ``optimizer_state_dict`` and
   ``scheduler_state_dict`` so that ``restore_latest`` continues exactly where
   training stopped.

The JAX package's Orbax checkpoints cannot be read without JAX; carry them
across with ``models.convert.flax_to_state_dict`` from a process that has JAX.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from cilrs_tpu_torch.cli.common import configure_numerics, require_cuda
from cilrs_tpu_torch.config import TrainConfig
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.models.convert import load_checkpoint
from cilrs_tpu_torch.train.state import TrainState

BEST_NAME = "checkpoint_best.pth"
LATEST_DIR = "latest"
LATEST_KEEP = 3
_LATEST_RE = re.compile(r"checkpoint_epoch_(\d+)\.pth")


def _cpu_state_dict(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _save(payload: dict, path: str):
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint_pth(path: str, model: CILRS, epoch: int, val_loss: float):
    """Write ``model``'s weights (on the CPU) in the notebook format."""
    _save({"model_state_dict": _cpu_state_dict(model), "epoch": int(epoch),
           "val_loss": float(val_loss)}, path)


def _latest_epochs(ckpt_dir: str) -> list[int]:
    d = os.path.join(ckpt_dir, LATEST_DIR)
    if not os.path.isdir(d):
        return []
    return sorted(int(m[1]) for name in os.listdir(d) if (m := _LATEST_RE.fullmatch(name)))


def _latest_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, LATEST_DIR, f"checkpoint_epoch_{epoch:04d}.pth")


def save_checkpoint(
    ckpt_dir: str,
    state: TrainState,
    epoch: int,
    val_loss: float,
    extra: dict[str, Any] | None = None,
    is_best: bool = False,
    latest: bool = True,
):
    """Save ``state`` to the rolling latest slot (when ``latest``) and/or the
    best slot (when ``is_best``)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    sd = _cpu_state_dict(state.model)
    meta = {"epoch": int(epoch), "val_loss": float(val_loss),
            # Architecture flag recorded so restorers can build the right model.
            "speed_skip": "speed_skip_w" in sd, **(extra or {})}
    if latest:
        os.makedirs(os.path.join(ckpt_dir, LATEST_DIR), exist_ok=True)
        _save({"model_state_dict": sd, **meta, "step": int(state.step),
               "optimizer_state_dict": state.optimizer.state_dict(),
               "scheduler_state_dict": state.scheduler.state_dict()},
              _latest_path(ckpt_dir, epoch))
        for old in _latest_epochs(ckpt_dir)[:-LATEST_KEEP]:
            os.remove(_latest_path(ckpt_dir, old))
    if is_best:
        os.makedirs(ckpt_dir, exist_ok=True)
        _save({"model_state_dict": sd, **meta}, os.path.join(ckpt_dir, BEST_NAME))
        with open(os.path.join(ckpt_dir, "best_epoch.txt"), "w") as f:
            f.write(f"{epoch} {val_loss}\n")


def restore_latest(ckpt_dir: str, state: TrainState):
    """Returns (state, epoch, val_loss) or (state, 0, inf) if nothing saved;
    the model, optimizer, schedule and step are restored in place."""
    epochs = _latest_epochs(os.path.abspath(ckpt_dir))
    if not epochs:
        return state, 0, float("inf")
    payload = torch.load(_latest_path(os.path.abspath(ckpt_dir), epochs[-1]),
                         map_location="cpu", weights_only=False)
    state.model.load_state_dict(payload["model_state_dict"])
    state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.scheduler.load_state_dict(payload["scheduler_state_dict"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), float(payload["val_loss"])


def restore_best_payload(ckpt_dir: str) -> dict:
    """The best checkpoint's payload dict, read without a model.

    Prefers the best slot; falls back to best_epoch.txt's epoch in the
    rolling slot (or its newest epoch) when there is no best file. Read
    without a model so the caller can inspect it (``payload_speed_skip``)
    before building the matching one."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    best = os.path.join(ckpt_dir, BEST_NAME)
    if os.path.exists(best):
        return load_checkpoint(best)
    epochs = _latest_epochs(ckpt_dir)
    if not epochs:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    epoch = epochs[-1]
    best_txt = os.path.join(ckpt_dir, "best_epoch.txt")
    if os.path.exists(best_txt):
        with open(best_txt) as f:
            want = int(f.read().split()[0])
        if want in epochs:
            epoch = want
    return load_checkpoint(_latest_path(ckpt_dir, epoch))


def payload_speed_skip(payload: dict) -> bool:
    """Whether a checkpoint payload was trained with the speed-skip head."""
    return "speed_skip_w" in payload["model_state_dict"]


def restore_best_params(ckpt_dir: str, state: TrainState) -> TrainState:
    """Load the best epoch's weights (params and BN statistics) into
    ``state.model``; the optimizer and schedule stay as they are. The model
    must have the matching architecture (see ``payload_speed_skip``)."""
    state.model.load_state_dict(restore_best_payload(ckpt_dir)["model_state_dict"])
    return state


def _stage_sizes(sd: dict) -> tuple:
    """Blocks in each of the trunk's four stages (``visual_encoder.4`` to
    ``.7``) of a CILRS state dict."""
    return tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual_encoder.{4 + s}.")})
                 for s in range(4))


def load_policy(path: str, cfg: TrainConfig | None = None, device="cuda") -> CILRS:
    """Notebook-format checkpoint -> CILRS in eval mode on ``device``.

    ``path`` is a ``.pth`` file or a checkpoint directory, read through its
    best slot (``restore_best_payload``). The architecture follows the
    checkpoint: ``speed_skip`` is on exactly when it holds ``speed_skip_w`` (a
    reference checkpoint has none), and the trunk's stage depths are counted
    from its blocks. On the card the trunk computes in bf16 under autocast
    (the JAX CILRS's default dtype) with ``channels_last`` weights, and TF32
    is turned off for what runs in float32 (``configure_numerics``); on the
    CPU everything is float32.
    """
    dev = require_cuda(device)
    if dev.type == "cuda":
        configure_numerics()
    cfg = cfg or TrainConfig()
    payload = restore_best_payload(path) if os.path.isdir(path) else load_checkpoint(path)
    sd = payload["model_state_dict"]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = CILRS(num_commands=cfg.model.num_commands, dropout=cfg.model.dropout, dtype=dtype,
                  stage_sizes=_stage_sizes(sd), speed_skip="speed_skip_w" in sd)
    model.load_state_dict(sd)
    return model.to(dev, memory_format=torch.channels_last).eval()
