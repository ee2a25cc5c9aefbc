"""Each architecture's FLOP counts (``policies/<arch>.py``) against torch's
flop counter on its reference model, and the byte counts (``counts.py``)
against their hand arithmetic."""

from __future__ import annotations

import os

import pytest

from conftest import counted_flops
from portbench import counts, harness
from portbench.reference.frozen.render.camera import CameraSpec

CONFIGS = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(harness.PB_DIR, "configs")))
# The configuration's own camera, and one of another size.
CAMERAS = [None, {"height": 66, "width": 150}]


@pytest.mark.parametrize("camera", CAMERAS)
@pytest.mark.parametrize("config", CONFIGS)
def test_flops_match_the_flop_counter_at_the_tiny_size(config, camera):
    cfg = harness.load_json("configs", config)
    camera = camera or cfg["sim"]["camera"]
    arch = harness.architecture(cfg["model"])
    model_cfg = arch.tiny(cfg["model"])
    cam = CameraSpec(**camera)
    assert arch.forward_flops(model_cfg, cam) == counted_flops(arch, model_cfg, camera, False)
    assert arch.train_flops(model_cfg, cam) == counted_flops(arch, model_cfg, camera, True)


def test_cilrs_flops_match_the_flop_counter_at_the_configuration():
    cfg = harness.load_json("configs", "cilrs34.benchtown")
    arch, model_cfg, camera = harness.architecture(cfg["model"]), cfg["model"], cfg["sim"]["camera"]
    cam = CameraSpec(**camera)
    assert arch.forward_flops(model_cfg, cam) == counted_flops(arch, model_cfg, camera, False) \
        == 2_798_183_168
    assert arch.train_flops(model_cfg, cam) == counted_flops(arch, model_cfg, camera, True) \
        == 8_311_758_848


def test_byte_counts():
    assert counts.ROW_BYTES == 52_800
    assert counts.gather_bytes(3_000) == 2 * 3_000 * 52_800
    assert counts.hash_bytes([("hash01", 10), ("grain_texture", 10), ("reverse_steer", 10)]) == 280
    # K1 at a group's 3,000 rows: 0.0946 ms at 3.35 TB/s.
    assert abs(counts.least_ms(counts.gather_bytes(3_000)) - 0.094567) < 1e-5
