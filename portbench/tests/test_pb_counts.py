"""counts.py against torch's flop counter on the reference model, and the
byte counts against their hand arithmetic."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.weights import reference_model

MODEL = {"num_commands": 4, "stage_sizes": [3, 4, 6, 3], "stage_features": [64, 128, 256, 512],
         "speed_skip": True}


def _flops(train: bool) -> int:
    model = reference_model(MODEL, 0.0)
    model.train(train)
    img = torch.zeros(1, 88, 200, 3)
    with FlopCounterMode(display=False) as fc:
        controls, speed = model(img, torch.zeros(1), torch.zeros(1, dtype=torch.long))
        if train:
            (controls.sum() + speed.sum()).backward()
    return fc.get_total_flops()


def test_forward_flops_match_the_flop_counter():
    assert counts.cilrs_forward_flops() == _flops(False) == 2_798_183_168


def test_train_flops_match_the_flop_counter():
    assert counts.cilrs_train_flops() == _flops(True) == 8_311_758_848


def test_byte_counts():
    assert counts.ROW_BYTES == 52_800
    assert counts.gather_bytes(3_000) == 2 * 3_000 * 52_800
    assert counts.hash_bytes([("hash01", 10), ("grain_texture", 10), ("reverse_steer", 10)]) == 280
    # K1 at a group's 3,000 rows: 0.0946 ms at 3.35 TB/s.
    assert abs(counts.least_ms(counts.gather_bytes(3_000)) - 0.094567) < 1e-5
