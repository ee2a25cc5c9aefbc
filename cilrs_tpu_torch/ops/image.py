"""ImageNet normalization (port of ``cilrs_tpu/ops/image.py:normalize``).

Frame resizing goes with the closed-loop drive and augmentation with training;
neither is on the offline-evaluation path.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img01: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize an NHWC image already in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img01.device)
    return (img01 - mean) / std
