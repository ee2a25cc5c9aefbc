"""The policy's weights of a run, made on the device from the seed in one
call of a ``torch.Generator`` on the card, and handed alike to the program
and to the reference. The tensors are those of the architecture's reference
model (``policies/<arch>.py:reference``), in its state dict's order: every
floating tensor of two or more dimensions (a convolution's or a linear
layer's kernel, the CILRS's [4, 3] speed skip) is normal with variance
1/fan_in (lecun-normal, untruncated); any other ``weight`` (a norm's scale)
1 + N(0, 0.05^2); every other floating tensor (shifts, biases)
N(0, 0.02^2); running statistics mean 0, variance 1."""

from __future__ import annotations

import math

import torch

from portbench import harness


def seeded_state_dict(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A state dict for the policy of ``model_cfg`` (names as its reference
    model's, which are the program's)."""
    with torch.device("meta"):
        shapes = harness.architecture(model_cfg).reference(model_cfg).state_dict()
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
        elif k.endswith("weight"):  # a norm's scale
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
