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

Data parallel (``mesh=``, the train loop's host-batch branch): each rank
holds its block of a global batch, which the JAX package trains as one
global-batch ``jit``. So the augmentation draws are the global batch's, of
which the rank applies its rows; BatchNorm normalizes by the global batch's
statistics, and dropout applies the rank's rows of the global batch's masks
(``models.cilrs.global_batch``); the gradients and the loss parts are
averaged over the ranks in one flat all-reduce before the update. So a world
of N differs from a world of 1 only in the order of its reductions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from cilrs_tpu_torch.config import TrainConfig
from cilrs_tpu_torch.models.cilrs import global_batch
from cilrs_tpu_torch.models.losses import cilrs_loss
from cilrs_tpu_torch.models.resnet import GlobalBatch
from cilrs_tpu_torch.ops.image import augment_batch, normalize
from cilrs_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, all_reduce_sum, block
from cilrs_tpu_torch.train.state import TrainState


def _prep_images(images_u8: torch.Tensor) -> torch.Tensor:
    return normalize(images_u8.float() / 255.0)


def step_seeds(seed: int, step: int) -> tuple[int, int]:
    """(augmentation seed, dropout seed) of update ``step`` of a run seeded
    with ``seed``."""
    a, d = np.random.SeedSequence([seed, step]).generate_state(2)
    return int(a), int(d)


def make_train_forward(mesh: Mesh | None = None):
    """The train-mode forward of a step: u8 -> /255 -> augmentation ->
    normalize -> the model in train mode, with the draws of update
    ``state.step`` of a run seeded ``seed``. Returns (controls, pred_speed).
    With ``mesh``, the batch is the rank's block of a global batch (see the
    module docstring)."""
    generators: dict[torch.device, torch.Generator] = {}

    def forward(state: TrainState, batch: dict, seed: int):
        dev = batch["images"].device
        aug_seed, drop_seed = step_seeds(seed, state.step)
        if dev not in generators:
            generators[dev] = torch.Generator(device=dev)
        gen = generators[dev].manual_seed(aug_seed)
        images = batch["images"].float() / 255.0
        if mesh is None:
            gb = None
            x = augment_batch(gen, images)
        else:
            n = images.shape[0] * mesh.world
            gb = GlobalBatch(n, block(mesh, n), functools.partial(all_reduce_sum, mesh))
            x = augment_batch(gen, images, n, gb.rows)
        x = normalize(x)
        model = state.model.train()
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), \
                global_batch(model, gb):
            torch.manual_seed(drop_seed)
            return model(x, batch["speed"], batch["command"])

    return forward


def make_train_step(cfg: TrainConfig, mesh: Mesh | None = None):
    loss_cfg = cfg.loss
    if cfg.training.speed_loss_boost != 1.0 or cfg.training.brake_loss_boost != 1.0:
        # Train-time-only reweighting of the aux speed / brake heads; eval
        # keeps the canonical weights so val_loss stays comparable across runs.
        loss_cfg = dataclasses.replace(
            loss_cfg,
            speed_weight=loss_cfg.speed_weight * cfg.training.speed_loss_boost,
            brake_weight=loss_cfg.brake_weight * cfg.training.brake_loss_boost,
        )
    forward = make_train_forward(mesh)

    def train_step(state: TrainState, batch: dict, seed: int) -> dict:
        """batch: images [B,H,W,3] u8, speed [B], command [B], controls [B,3],
        on the model's device (with a mesh, the rank's block). Updates
        ``state`` in place and returns the loss parts (of the global batch)
        as device tensors (no host sync)."""
        controls, pred_speed = forward(state, batch, seed)
        total, parts = cilrs_loss(controls, pred_speed, batch["controls"], batch["speed"], loss_cfg)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        values = torch.stack([v.detach() for v in parts.values()])
        if mesh is not None:
            all_reduce_mean_(mesh, [p.grad for p in state.model.parameters() if p.grad is not None]
                             + [values])
        state.apply_gradients()
        return dict(zip(parts, values))

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
