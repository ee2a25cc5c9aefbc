"""Train and eval steps (port of ``cilrs_tpu/train/steps.py``).

Train: u8 -> /255 -> augmentation -> ImageNet normalize -> the CILRS forward
in train mode (bf16 autocast and ``channels_last`` on the card) -> the
weighted loss with the train-only boosts -> backward -> clip -> Adam -> the
schedule. The step's random draws depend only on (seed, step), as the JAX
step's ``fold_in(rng, state.step)``: augmentation draws from a generator
seeded for the step, and dropout from the global generators seeded for the
step inside ``fork_rng``, which restores them afterwards, so no random state
carries from one step to the next and a resumed run draws what the
uninterrupted one would have.

Eval: the forward in eval mode, the loss parts, per-command |steer error|
sums and counts, and ``pred`` = [steer, throttle, brake, pred_speed].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cilrs_tpu_torch.config import TrainConfig
from cilrs_tpu_torch.models.losses import cilrs_loss
from cilrs_tpu_torch.ops.image import augment_batch, normalize
from cilrs_tpu_torch.train.state import TrainState


def _prep_images(images_u8: torch.Tensor) -> torch.Tensor:
    return normalize(images_u8.float() / 255.0)


def step_seeds(seed: int, step: int) -> tuple[int, int]:
    """(augmentation seed, dropout seed) of update ``step`` of a run seeded
    with ``seed``."""
    a, d = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(a), int(d)


def make_train_forward():
    """The train-mode forward of a step: u8 -> /255 -> augmentation ->
    normalize -> the model in train mode, with the draws of update
    ``state.step`` of a run seeded ``seed``. Returns (controls, pred_speed)."""
    generators: dict[torch.device, torch.Generator] = {}

    def forward(state: TrainState, batch: dict, seed: int):
        dev = batch["images"].device
        aug_seed, drop_seed = step_seeds(seed, state.step)
        if dev not in generators:
            generators[dev] = torch.Generator(device=dev)
        gen = generators[dev].manual_seed(aug_seed)
        x = normalize(augment_batch(gen, batch["images"].float() / 255.0))
        model = state.model.train()
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(drop_seed)
            return model(x, batch["speed"], batch["command"])

    return forward


def make_train_step(cfg: TrainConfig):
    loss_cfg = cfg.loss
    if cfg.training.speed_loss_boost != 1.0 or cfg.training.brake_loss_boost != 1.0:
        # Train-time-only reweighting of the aux speed / brake heads; eval
        # keeps the canonical weights so val_loss stays comparable across runs.
        loss_cfg = dataclasses.replace(
            loss_cfg,
            speed_weight=loss_cfg.speed_weight * cfg.training.speed_loss_boost,
            brake_weight=loss_cfg.brake_weight * cfg.training.brake_loss_boost,
        )
    forward = make_train_forward()

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        """batch: images [B,H,W,3] u8, speed [B], command [B], controls [B,3],
        on the model's device. Updates ``state`` in place and returns the loss
        parts as device tensors (no host sync)."""
        controls, pred_speed = forward(state, batch, seed)
        total, parts = cilrs_loss(controls, pred_speed, batch["controls"], batch["speed"], loss_cfg)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in parts.items()}

    return train_step


def make_eval_step(cfg: TrainConfig):
    loss_cfg = cfg.loss

    @torch.inference_mode()
    def eval_step(model: torch.nn.Module, batch: dict) -> dict:
        """batch: images [B,H,W,3] u8, speed [B], command [B], controls [B,3],
        all on the model's device; ``model`` is in eval mode."""
        x = _prep_images(batch["images"])
        controls, pred_speed = model(x, batch["speed"], batch["command"])
        _, parts = cilrs_loss(controls, pred_speed, batch["controls"], batch["speed"], loss_cfg)
        steer_err = (controls[:, 0] - batch["controls"][:, 0]).abs()
        onehot = F.one_hot(batch["command"].long(), 4).float()
        parts = dict(parts)
        parts["cmd_steer_err_sum"] = onehot.T @ steer_err  # [4]
        parts["cmd_count"] = onehot.sum(dim=0)  # [4]
        parts["pred"] = torch.cat([controls, pred_speed[:, None]], dim=1)
        return parts

    return eval_step
