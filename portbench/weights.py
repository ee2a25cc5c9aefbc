"""The CILRS weights of a run, made on the device from the seed in one call
of a ``torch.Generator`` on the card, and handed alike to the program and to
the reference. Every convolution and linear kernel is normal with variance
1/fan_in (lecun-normal, untruncated); BatchNorm scales are 1 + N(0, 0.05^2),
their shifts, the linear biases and the speed skip N(0, 0.02^2); running
statistics mean 0, variance 1."""

from __future__ import annotations

import math

import torch

from portbench.reference.frozen.models.cilrs import CILRS


def reference_model(model_cfg: dict, dropout: float) -> CILRS:
    """The frozen CILRS in float32 (no autocast) at ``model_cfg``'s widths, on
    the current default device."""
    return CILRS(num_commands=model_cfg["num_commands"], dropout=dropout, dtype=torch.float32,
                 stage_sizes=tuple(model_cfg["stage_sizes"]),
                 stage_features=tuple(model_cfg["stage_features"]),
                 speed_skip=model_cfg["speed_skip"])


def seeded_state_dict(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict for the CILRS of ``model_cfg`` (names as the program's)."""
    with torch.device("meta"):
        shapes = reference_model(model_cfg, 0.0).state_dict()
    floats = [(k, v.shape) for k, v in shapes.items() if v.is_floating_point()
              and not k.endswith(("running_mean", "running_var"))]
    total = sum(math.prod(s) for _, s in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in floats:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            x = x * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif k.endswith("weight"):  # a BatchNorm scale
            x = 1.0 + 0.05 * x
        else:
            x = 0.02 * x
        out[k] = x
    for k, v in shapes.items():
        if k.endswith("running_mean"):
            out[k] = torch.zeros(v.shape, device=device)
        elif k.endswith("running_var"):
            out[k] = torch.ones(v.shape, device=device)
        elif not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out


def load_into(model: torch.nn.Module, sd: dict[str, torch.Tensor]) -> None:
    """Copy ``sd`` into ``model``'s tensors in place (their layout kept)."""
    model.load_state_dict(sd, strict=True)
