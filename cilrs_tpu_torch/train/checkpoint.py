"""Policy checkpoints in the notebook's ``.pth`` format.

``{"model_state_dict", "epoch", "val_loss"}``, the format the reference's
training notebook writes and ``cilrs_tpu``'s torch import reads. The JAX
package's Orbax checkpoints cannot be read without JAX; carry them across with
``models.convert.flax_to_state_dict`` from a process that has JAX.
"""

from __future__ import annotations

import os

import torch

from cilrs_tpu_torch.cli.common import configure_numerics, require_cuda
from cilrs_tpu_torch.config import TrainConfig
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.models.convert import load_checkpoint


def save_checkpoint_pth(path: str, model: CILRS, epoch: int, val_loss: float):
    """Write ``model``'s weights (on the CPU) in the notebook format."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save({"model_state_dict": sd, "epoch": int(epoch),
                "val_loss": float(val_loss)}, tmp)
    os.replace(tmp, path)


def load_policy(path: str, cfg: TrainConfig | None = None, device="cuda") -> CILRS:
    """Notebook-format checkpoint -> CILRS in eval mode on ``device``.

    The architecture follows the checkpoint: ``speed_skip`` is on exactly when
    it holds ``speed_skip_w`` (a reference checkpoint has none). On the card
    the trunk computes in bf16 under autocast (the JAX CILRS's default dtype)
    with ``channels_last`` weights, and TF32 is turned off for what runs in
    float32 (``configure_numerics``); on the CPU everything is float32.
    """
    dev = require_cuda(device)
    if dev.type == "cuda":
        configure_numerics()
    cfg = cfg or TrainConfig()
    sd = load_checkpoint(path)["model_state_dict"]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = CILRS(num_commands=cfg.model.num_commands, dropout=cfg.model.dropout, dtype=dtype,
                  stage_sizes=tuple(cfg.model.stage_sizes), speed_skip="speed_skip_w" in sd)
    model.load_state_dict(sd)
    return model.to(dev, memory_format=torch.channels_last).eval()
