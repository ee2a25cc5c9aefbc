"""Train state: the model, its optimizer and schedule, and the update count
(port of ``cilrs_tpu/train/state.py``).

The optimizer is the JAX package's optax chain (state.py:72-77), in order:
 - global-norm gradient clipping at ``gradient_clip`` as optax clips: the
   gradient is scaled by max/||g|| only when ||g|| >= max, with no epsilon
   (``torch.nn.utils.clip_grad_norm_`` divides by ||g|| + 1e-6);
 - coupled L2 ``weight_decay`` added to the gradient of every parameter (BN
   scales, biases and ``speed_skip_w`` included), then Adam(0.9, 0.999,
   1e-8): ``torch.optim.Adam(weight_decay=...)`` is both;
 - the learning-rate schedule indexed by the update count: a ``LambdaLR``
   stepped after every ``optimizer.step()``, so update t uses sched(t).

``create_train_state`` initialises the weights as Flax does (lecun-normal
kernels, zero biases, BN scale 1 and bias 0, zero speed skip) from a seed.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cilrs_tpu_torch.cli.common import configure_numerics, require_cuda
from cilrs_tpu_torch.config import OptimizerConfig, TrainConfig
from cilrs_tpu_torch.models.cilrs import CILRS
from cilrs_tpu_torch.utils.profiling import span


def step_lr(cfg: OptimizerConfig, steps_per_epoch: int):
    """StepLR(step_size=lr_step_epochs epochs, gamma) as a step-indexed schedule."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        k = epoch // cfg.lr_step_epochs
        return cfg.learning_rate * (cfg.lr_step_gamma ** k)

    return schedule


def cosine_lr(cfg: OptimizerConfig, total_steps: int):
    """optax.warmup_cosine_decay_schedule as the JAX ``make_optimizer`` sets
    it: linear warmup from 5% of the lr to the lr, cosine decay to 1%."""
    warmup = min(max(total_steps // 50, 10), max(total_steps // 2, 1))
    init, peak, end = cfg.learning_rate * 0.05, cfg.learning_rate, cfg.learning_rate * 0.01
    decay = max(total_steps, warmup + 1) - warmup
    alpha = end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            return (init - peak) * (1 - max(count, 0) / warmup) + peak
        c = min(count - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


def make_optimizer(params, cfg: OptimizerConfig, steps_per_epoch: int, schedule: str = "step",
                   total_steps: int | None = None):
    """(Adam with coupled L2, LambdaLR) over ``params``. ``schedule``: "step" =
    notebook StepLR parity; "cosine" = warmup + cosine (needs total_steps).
    Clipping is ``clip_by_global_norm_``, called before ``optimizer.step()``."""
    if schedule == "cosine":
        if total_steps is None:
            raise ValueError("the cosine schedule needs total_steps")
        sched = cosine_lr(cfg, total_steps)
    else:
        sched = step_lr(cfg, steps_per_epoch)
    params = list(params)
    opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay, fused=params[0].is_cuda)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: sched(t) / cfg.learning_rate)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place and
    without a host sync. Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm


@dataclasses.dataclass
class TrainState:
    model: CILRS
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    max_grad_norm: float
    step: int = 0

    def apply_gradients(self) -> None:
        """One update of the optax chain from the gradients in ``.grad``."""
        clip_by_global_norm_(self.optimizer.param_groups[0]["params"], self.max_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1


@torch.no_grad()
def flax_init_(model: nn.Module, gen: torch.Generator) -> None:
    """Flax's default initialisers: lecun_normal (a normal truncated at 2
    standard deviations, rescaled to variance 1/fan_in) for every conv and
    dense kernel, zeros for their biases; BatchNorm keeps scale 1, bias 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            if m.bias is not None:
                m.bias.zero_()


@span("model_init")
def create_train_state(cfg: TrainConfig, seed: int, steps_per_epoch: int = 1000,
                       schedule: str = "step", total_steps: int | None = None,
                       device="cuda") -> TrainState:
    """Model initialised from ``seed`` on ``device`` in train mode, with its
    optimizer and schedule. On the card the trunk computes in bf16 under
    autocast with ``channels_last`` weights; on the CPU in float32."""
    dev = require_cuda(device)
    if dev.type == "cuda":
        configure_numerics()
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = CILRS(num_commands=cfg.model.num_commands, dropout=cfg.model.dropout, dtype=dtype,
                  stage_sizes=tuple(cfg.model.stage_sizes), speed_skip=cfg.model.speed_skip)
    flax_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(dev, memory_format=torch.channels_last).train()
    opt, sched = make_optimizer(model.parameters(), cfg.optimizer, steps_per_epoch, schedule,
                                total_steps)
    return TrainState(model, opt, sched, cfg.optimizer.gradient_clip)
