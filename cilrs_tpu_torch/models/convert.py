"""Carry weights into the port: JAX-package variables and notebook ``.pth`` files.

``flax_to_state_dict`` maps the JAX CILRS's ``params`` / ``batch_stats`` (nested
dicts of numpy arrays) onto this package's ``state_dict``, for any
``stage_sizes``: conv kernels HWIO -> OIHW, Dense kernels [in, out] ->
[out, in], and the stacked branch tensors (w1 [640, K*256], w2 [K, 256, 256],
w3 [K, 256, 3]) split into the per-command ``control_branches.k``.

``load_checkpoint`` reads a notebook-format ``.pth`` file
({"model_state_dict", "epoch", "val_loss"}), including one pickled under the
other NumPy major version (the reference's ``numpy._core`` alias shim).
``load_torchvision_trunk`` grafts a torchvision resnet34 state dict onto the
trunk (``--pretrained-backbone``).
"""

from __future__ import annotations

import re
import sys
import types
from collections import OrderedDict

import numpy as np
import torch


def _install_numpy_pickle_shims():
    """Allow unpickling checkpoints across the NumPy 1/2 module rename."""
    if "numpy._core" not in sys.modules:  # NumPy 1: alias its numpy.core
        import numpy.core as _nc

        mod = types.ModuleType("numpy._core")
        mod.__dict__.update(_nc.__dict__)
        sys.modules["numpy._core"] = mod
        for sub in ("multiarray", "umath", "_multiarray_umath"):
            full = f"numpy._core.{sub}"
            if full not in sys.modules and hasattr(_nc, sub):
                sys.modules[full] = getattr(_nc, sub)


def load_checkpoint(path: str) -> dict:
    """Notebook-format checkpoint -> {"model_state_dict", "epoch", "val_loss", ...}
    on the CPU. A bare state dict is wrapped into that form."""
    _install_numpy_pickle_shims()
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        return blob
    return {"model_state_dict": blob}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(w) -> torch.Tensor:  # HWIO -> OIHW
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _lin(w) -> torch.Tensor:  # [in, out] -> [out, in]
    return _t(np.transpose(np.asarray(w), (1, 0)))


def flax_to_state_dict(params: dict, batch_stats: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX CILRS variables (numpy leaves) -> this package's CILRS state_dict."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    enc_p, enc_s = params["visual_encoder"], batch_stats["visual_encoder"]

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = _t(p["scale"])
        sd[f"{prefix}.bias"] = _t(p["bias"])
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    sd["visual_encoder.0.weight"] = _conv(enc_p["conv1"]["kernel"])
    bn("visual_encoder.1", enc_p["bn1"], enc_s["bn1"])
    blocks = sorted((int(m[1]), int(m[2]), name) for name in enc_p
                    if (m := re.fullmatch(r"layer(\d+)_(\d+)", name)))
    for stage, block, name in blocks:
        t = f"visual_encoder.{3 + stage}.{block}"
        p, s = enc_p[name], enc_s[name]
        sd[f"{t}.conv1.weight"] = _conv(p["conv1"]["kernel"])
        bn(f"{t}.bn1", p["bn1"], s["bn1"])
        sd[f"{t}.conv2.weight"] = _conv(p["conv2"]["kernel"])
        bn(f"{t}.bn2", p["bn2"], s["bn2"])
        if "downsample_conv" in p:
            sd[f"{t}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            bn(f"{t}.downsample.1", p["downsample_bn"], s["downsample_bn"])

    for slot, name in ((0, "speed_fc1"), (3, "speed_fc2")):
        sd[f"speed_encoder.{slot}.weight"] = _lin(params[name]["kernel"])
        sd[f"speed_encoder.{slot}.bias"] = _t(params[name]["bias"])
    for slot, name in ((0, "speed_pred_fc1"), (3, "speed_pred_fc2"), (5, "speed_pred_out")):
        sd[f"speed_predictor.{slot}.weight"] = _lin(params[name]["kernel"])
        sd[f"speed_predictor.{slot}.bias"] = _t(params[name]["bias"])

    br = params["branches"]
    w1, b1 = np.asarray(br["w1"]), np.asarray(br["b1"])
    num_commands, hidden = np.asarray(br["w2"]).shape[:2]
    for k in range(num_commands):
        t = f"control_branches.{k}"
        cols = slice(k * hidden, (k + 1) * hidden)
        sd[f"{t}.0.weight"] = _lin(w1[:, cols])
        sd[f"{t}.0.bias"] = _t(b1[cols])
        sd[f"{t}.3.weight"] = _lin(np.asarray(br["w2"])[k])
        sd[f"{t}.3.bias"] = _t(np.asarray(br["b2"])[k])
        sd[f"{t}.6.weight"] = _lin(np.asarray(br["w3"])[k])
        sd[f"{t}.6.bias"] = _t(np.asarray(br["b3"])[k])
    if "speed_skip_w" in br:
        sd["speed_skip_w"] = _t(br["speed_skip_w"])
    return sd


# A plain torchvision ResNet's top-level modules -> slots of the port's
# visual_encoder Sequential (2 relu, 3 maxpool, 8 avgpool and fc have no
# trunk weights).
_TORCHVISION_SLOTS = {"conv1": 0, "bn1": 1, "layer1": 4, "layer2": 5, "layer3": 6, "layer4": 7}


def load_torchvision_trunk(model: torch.nn.Module, path_or_sd) -> None:
    """Graft an ImageNet-pretrained torchvision resnet34 state dict (names
    conv1/bn1/layer{1..4}.*; a ``.pth`` path or a loaded {name: tensor}
    dict) onto ``model.visual_encoder`` in place; the heads stay as they are
    and ``fc.*`` is ignored. Every trunk tensor must exist with the same
    shape, else it raises. The counterpart of
    ``cilrs_tpu/models/torch_import.py:init_trunk_from_torchvision``."""
    if isinstance(path_or_sd, str):
        _install_numpy_pickle_shims()
        path_or_sd = torch.load(path_or_sd, map_location="cpu", weights_only=False)
    src = path_or_sd.get("model_state_dict", path_or_sd)
    dst = model.visual_encoder.state_dict()
    mapped = {}
    for name, value in src.items():
        head, _, rest = name.partition(".")
        if head not in _TORCHVISION_SLOTS:
            continue
        key = f"{_TORCHVISION_SLOTS[head]}.{rest}"
        value = torch.as_tensor(value)
        if key not in dst or dst[key].shape != value.shape:
            want = tuple(dst[key].shape) if key in dst else "no such tensor"
            raise ValueError(f"torchvision trunk tensor {name} {tuple(value.shape)} "
                             f"does not fit visual_encoder.{key}: {want}")
        mapped[key] = value.to(dst[key].dtype)
    missing = sorted(k for k in dst if k not in mapped and not k.endswith("num_batches_tracked"))
    if missing:
        raise ValueError(f"torchvision state dict lacks trunk tensors: {missing[:5]}")
    model.visual_encoder.load_state_dict(mapped, strict=False)
