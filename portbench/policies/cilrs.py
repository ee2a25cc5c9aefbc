"""The CILRS: a ResNet-34 conditional imitation policy over one camera frame,
with a speed encoder, four command branches and an auxiliary speed head
(``configs/cilrs34.*.json``'s source). Its reference is the frozen copy in
float32 (``reference/frozen/models/cilrs.py``); the program's is
``cilrs_tpu_torch/models/cilrs.py`` as ``train/state.py:create_train_state``
builds it.

An architecture module of the harness gives ``reference``, ``program``,
``reference_policy``, ``forward_flops``, ``train_flops`` and ``tiny``; a
configuration names it by ``model.arch``. A policy that carries state from
tick to tick (a controller's window of errors) also gives ``carry(policy)``:
the carry of the policy ``program`` returned as it stands, a dict of tensors
[E, ...] that the policy updates in place, or None. Its
``reference_policy`` then takes ``carry=`` (the program's carry before the
tick, which it leaves as it is) and returns (controls, the carry after the
tick). The CILRS carries nothing and has no ``carry``.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.models.cilrs import CILRS
from portbench.reference.frozen.ops.image import normalize
from portbench.weights import load_into


def reference(model_cfg: dict) -> torch.nn.Module:
    """The frozen CILRS in float32 (no autocast) at ``model_cfg``'s widths and
    dropout, on the current default device."""
    return CILRS(num_commands=model_cfg["num_commands"], dropout=model_cfg["dropout"],
                 dtype=torch.float32, stage_sizes=tuple(model_cfg["stage_sizes"]),
                 stage_features=tuple(model_cfg["stage_features"]),
                 speed_skip=model_cfg["speed_skip"])


def program_config(model_cfg: dict, dropout: float):
    """The program's ``ModelConfig`` of ``model_cfg``, with ``dropout``."""
    from cilrs_tpu_torch.config import ModelConfig

    return ModelConfig(dropout=dropout, num_commands=model_cfg["num_commands"],
                       stage_sizes=tuple(model_cfg["stage_sizes"]),
                       speed_skip=model_cfg["speed_skip"])


def program(model_cfg: dict, sd: dict, device, fp32: bool = False):
    """The program's CILRS in eval mode, as the drive CLIs build it
    (``train.state.create_train_state``: bf16 autocast and ``channels_last``
    on the card, the CLIs' float32 settings), holding the weights ``sd``;
    and the fleet policy over it (``agent/driver.py:model_policy``). ``fp32``
    turns its autocast off: a witness for the check, never a run."""
    from cilrs_tpu_torch.agent.driver import model_policy
    from cilrs_tpu_torch.config import TrainConfig
    from cilrs_tpu_torch.train.state import create_train_state

    cfg = TrainConfig(model=program_config(model_cfg, 0.0))
    # The seed of the program's own init is moot: ``sd`` replaces every weight.
    model = create_train_state(cfg, 0, device=device).model.eval()
    if fp32:
        model.dtype = torch.float32
    load_into(model, sd)
    return model, model_policy(model)


def reference_policy(model: torch.nn.Module, frame01: torch.Tensor, obs: dict, state,
                     pool) -> torch.Tensor:
    """The reference CILRS's controls [E, 3] on the frozen observation: the
    frame normalized, the normalized speed and the command."""
    return model(normalize(frame01), obs["speed_norm"], obs["cmd"])[0]


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def layers(model_cfg: dict, camera) -> list[tuple[str, int]]:
    """(layer, forward FLOPs of one frame) of every convolution and linear
    layer, in the order the forward runs them, on ``camera``'s frame."""
    out = []

    def conv(name, cin, cout, k, s, p, hw):
        ho, wo = _conv_out(hw[0], k, s, p), _conv_out(hw[1], k, s, p)
        out.append((name, 2 * cin * cout * k * k * ho * wo))
        return ho, wo

    hw = conv("conv1", 3, 64, 7, 2, 3, (camera.height, camera.width))  # the stem: 64 wide
    hw = (_conv_out(hw[0], 3, 2, 1), _conv_out(hw[1], 3, 2, 1))  # max pool
    cin = 64
    stage_features = model_cfg["stage_features"]
    for stage, (blocks, feats) in enumerate(zip(model_cfg["stage_sizes"], stage_features)):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            if stride != 1 or cin != feats:
                conv(f"layer{stage + 1}.{b}.downsample", cin, feats, 1, stride, 0, hw)
            hw_in = hw
            hw = conv(f"layer{stage + 1}.{b}.conv1", cin, feats, 3, stride, 1, hw_in)
            conv(f"layer{stage + 1}.{b}.conv2", feats, feats, 3, 1, 1, hw)
            cin = feats

    def linear(name, i, o):
        out.append((name, 2 * i * o))

    visual, speed, branch = stage_features[-1], model_cfg["speed_dim"], model_cfg["branch_hidden"]
    linear("speed_encoder.0", 1, speed)
    linear("speed_encoder.3", speed, speed)
    linear("speed_predictor.0", visual, branch)
    linear("speed_predictor.3", branch, branch)
    linear("speed_predictor.5", branch, 1)
    for c in range(model_cfg["num_commands"]):  # every branch runs; the command selects after
        linear(f"control_branches.{c}.0", visual + speed, branch)
        linear(f"control_branches.{c}.3", branch, branch)
        linear(f"control_branches.{c}.6", branch, 3)
    return out


def forward_flops(model_cfg: dict, camera) -> int:
    """Forward FLOPs of one frame of ``camera`` (its ``height`` and
    ``width``): 2,798,183,168 at the published widths and 88x200."""
    return sum(f for _, f in layers(model_cfg, camera))


def train_flops(model_cfg: dict, camera) -> int:
    """Forward and backward FLOPs of one trained frame: the backward takes the
    gradient of every layer's weights and of every layer's input but the
    image's (``conv1``) and the speed's (``speed_encoder.0``), which need none
    (8,311,758,848 at the published widths and 88x200)."""
    per_layer = dict(layers(model_cfg, camera))
    return 3 * sum(per_layer.values()) - per_layer["conv1"] - per_layer["speed_encoder.0"]


def tiny(model_cfg: dict) -> dict:
    """The CPU tests' size: one basic block a stage, the widths as they are."""
    return {**model_cfg, "stage_sizes": [1, 1, 1, 1]}
