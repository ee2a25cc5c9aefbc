"""Shared entry-point helpers (counterpart of ``cilrs_tpu/cli/common.py``)."""

from __future__ import annotations

import torch


def require_cuda(device="cuda") -> torch.device:
    """Resolve an entry point's ``device``; fail fast when CUDA is asked for
    and no GPU is present, rather than carry on on the CPU. A run on the CPU
    is asked for explicitly, with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"cilrs_tpu_torch: device {device!r} was asked for but no CUDA GPU "
            "is available; pass device='cpu' for a deliberate CPU run")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cilrs_tpu_torch runs on 'cuda' or 'cpu', not {device!r}")
    return dev


def configure_numerics() -> None:
    """The port's float32 settings on the card: matmuls and convolutions that
    run in float32 (the heads; nothing else when the trunk is under bf16
    autocast) use full float32, not TF32, as the JAX package's float32 Dense
    layers do on the CPU reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_map(spec: str):
    """--map town01 (default) | mini | osm:<path.osm>. The network is built
    on the CPU; callers move it."""
    from cilrs_tpu_torch.maps.town import make_mini_town, make_town01

    if spec in ("town01", "Town01", ""):
        return make_town01()
    if spec == "mini":
        return make_mini_town()
    if spec.startswith("osm:"):
        from cilrs_tpu_torch.maps.osm import load_osm_network

        return load_osm_network(spec[4:])
    raise SystemExit(f"unknown --map {spec!r} (use town01 | mini | osm:<path>)")


def load_policy(checkpoint: str | None, device="cuda", cfg=None):
    """The CILRS model the drive CLIs run, in eval mode on ``device``: a
    ``.pth`` file or a checkpoint directory (its best slot) through
    ``train.checkpoint.load_policy``, or with no checkpoint the untrained
    model of ``train.state.create_train_state`` (Flax-style init, seed 0)."""
    from cilrs_tpu_torch.config import TrainConfig
    from cilrs_tpu_torch.train.checkpoint import load_policy as load_checkpoint_policy
    from cilrs_tpu_torch.train.state import create_train_state

    cfg = cfg or TrainConfig()
    if checkpoint:
        model = load_checkpoint_policy(checkpoint, cfg, device)
        print(f"  loaded checkpoint: {checkpoint} (speed_skip={model.speed_skip})")
        return model
    print("  WARNING: no --checkpoint given; driving with an untrained policy")
    return create_train_state(cfg, 0, device=device).model.eval()
