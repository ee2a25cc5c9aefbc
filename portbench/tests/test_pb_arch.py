"""A second policy architecture needs only new files: a stub architecture in
a temporary ``policies/<arch>.py``, named by a configuration's
``model.arch`` and found by the harness's own lookup, drives the tiny fleet
and drive windows and comes out correct, its planted faults do not, and its
FLOPs are its own. No file of the harness is touched. And a program whose
fleet takes a camera renders the configuration's camera, which the check
follows; one that takes none refuses any camera but the default."""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import sys

import pytest

from conftest import counted_flops
from portbench import counts, faults, harness
from portbench.reference.frozen.render.camera import CameraSpec

STUB = "stub_conv_pb"
# Two convolutions and a linear head over the pooled features, the speed and
# the command. Its reference reads the speed in km/h from the observation, a
# key the CILRS ignores, where the program's policy is handed the normalized
# speed.
STUB_SOURCE = '''"""A stub policy of the harness's tests: two convolutions and a linear head."""

import torch
import torch.nn.functional as F

from portbench.reference.frozen.config import SPEED_NORM_FACTOR
from portbench.reference.frozen.ops.image import normalize


class StubNet(torch.nn.Module):
    def __init__(self, channels):
        super().__init__()
        c0, c1 = channels
        self.conv1 = torch.nn.Conv2d(3, c0, 5, stride=4, padding=2)
        self.conv2 = torch.nn.Conv2d(c0, c1, 3, stride=2, padding=1)
        self.head = torch.nn.Linear(c1 + 2, 3)

    def forward(self, image, speed, cmd):
        x = F.relu(self.conv1(image.permute(0, 3, 1, 2)))
        x = F.relu(self.conv2(x)).mean((2, 3))
        return self.head(torch.cat([x, speed[:, None], cmd[:, None].float()], 1))


def reference(model_cfg):
    """The stub in float32."""
    return StubNet(model_cfg["channels"])


def program(model_cfg, sd, device, fp32=False):
    """The stub on the device with ``sd``, and its fleet policy."""
    model = StubNet(model_cfg["channels"]).to(device).eval()
    model.load_state_dict(sd)
    return model, lambda image, speed_norm, cmd: model(image, speed_norm, cmd)


def reference_policy(model, frame01, obs, state, pool):
    """The stub's controls, its speed worked out from the km/h reading."""
    speed = torch.clamp(obs["speed_kmh"] / SPEED_NORM_FACTOR, 0.0, 1.0)
    return model(normalize(frame01), speed, obs["cmd"])


def _convs(model_cfg, camera):
    c0, c1 = model_cfg["channels"]
    h1, w1 = (camera.height - 1) // 4 + 1, (camera.width - 1) // 4 + 1
    h2, w2 = (h1 - 1) // 2 + 1, (w1 - 1) // 2 + 1
    return 2 * 3 * c0 * 25 * h1 * w1, 2 * c0 * c1 * 9 * h2 * w2, 2 * (c1 + 2) * 3


def forward_flops(model_cfg, camera):
    """Both convolutions and the head."""
    return sum(_convs(model_cfg, camera))


def train_flops(model_cfg, camera):
    """Forward and backward but the image's gradient."""
    return 3 * forward_flops(model_cfg, camera) - _convs(model_cfg, camera)[0]


def tiny(model_cfg):
    """The stub is tiny."""
    return model_cfg
'''
STUB_MODEL = {"arch": STUB, "channels": [8, 16]}


def _harness_files() -> dict[str, str]:
    out = {}
    for root, dirs, files in os.walk(harness.PB_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), harness.PB_DIR)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def stub():
    """The stub's file in ``policies/`` while the module's tests run; the
    harness's files are as they were once it is gone."""
    path = os.path.join(harness.PB_DIR, "policies", f"{STUB}.py")
    before = _harness_files()
    with open(path, "w") as f:
        f.write(STUB_SOURCE)
    try:
        yield harness.architecture(STUB_MODEL)
    finally:
        os.remove(path)
        sys.modules.pop(f"portbench.policies.{STUB}", None)
        assert _harness_files() == before


def _stub_ctx(tiny, cell: str):
    ctx = tiny(cell)
    ctx.config["model"] = copy.deepcopy(STUB_MODEL)
    return ctx


def test_the_stub_is_found_by_name(stub):
    assert stub.__name__ == f"portbench.policies.{STUB}"
    assert harness.architecture(STUB_MODEL) is stub


def test_an_unknown_arch_is_refused():
    with pytest.raises(ValueError, match="names no portbench/policies"):
        harness.architecture({"arch": "no_such_policy"})


@pytest.mark.parametrize("cell", ["fleet128.benchtown", "drive1.town01"])
def test_the_stub_drives_a_correct_window(stub, tiny, cell):
    ctx = _stub_ctx(tiny, cell)
    out = harness.load_module("drivers", ctx.workload["driver"]).run(ctx)
    checked = harness.check_line(out["checked"])
    assert all(c["ok"] for c in checked.values()), checked
    assert out["attempted"] >= 1 and out["failed"] == 0
    cam = CameraSpec(**ctx.config["sim"]["camera"])
    frames = next(iter(out["e2e"].values()))
    assert out["rec"]["mfu_pct"] == pytest.approx(
        frames * stub.forward_flops(STUB_MODEL, cam) / counts.PEAK_BF16_FLOPS * 100)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_the_stub_with_a_fault_is_not_correct(stub, tiny, monkeypatch, fault):
    ctx = _stub_ctx(tiny, "fleet128.benchtown")
    driver = harness.load_module("drivers", "fleet")
    orig = driver.simrun.record_chunk

    def faulty(chunk, owner):
        with faults.sim_fault(fault, owner):
            return orig(chunk, owner)

    monkeypatch.setattr(driver.simrun, "record_chunk", faulty)
    checked = harness.check_line(driver.run(ctx)["checked"])
    assert not all(c["ok"] for c in checked.values()), checked


@pytest.mark.parametrize("camera", [{"height": 88, "width": 200}, {"height": 48, "width": 96}])
def test_the_stub_flops_match_the_flop_counter(stub, camera):
    cam = CameraSpec(**camera)
    assert stub.forward_flops(STUB_MODEL, cam) == counted_flops(stub, STUB_MODEL, camera, False)
    assert stub.train_flops(STUB_MODEL, cam) == counted_flops(stub, STUB_MODEL, camera, True)
    assert stub.forward_flops(STUB_MODEL, cam) != harness.architecture(
        {"arch": "cilrs"}).forward_flops(harness.load_json("configs", "cilrs34.benchtown")["model"],
                                         cam)


def _fleet_with_camera():
    """The program's ``BenchFleet`` with a ``cam`` field that its chunk
    passes to ``fleet_rollout``."""
    from cilrs_tpu_torch.agent.driver import fleet_rollout
    from cilrs_tpu_torch.agent.npc import draw_pedestrians
    from cilrs_tpu_torch.bench.env_steps import BenchFleet
    from cilrs_tpu_torch.core.state import tree_map
    from cilrs_tpu_torch.render.raster import CAMERA

    @dataclasses.dataclass
    class CameraFleet(BenchFleet):
        cam: object = CAMERA

        def chunk(self):
            w = self.state.world
            E = w.num_envs
            draws = draw_pedestrians(self.generator, self.ticks, E, w.num_pedestrians,
                                     w.veh_pos.device)
            pool = tree_map(lambda x: x.expand((E,) + x.shape), self.pool)
            self.state, _ = fleet_rollout(self.state, self.ticks, self.net, pool, self.wt,
                                          self.params, draws, mode="drive", cam=self.cam,
                                          policy=self.policy, want_frames=False)
            return self.state

    return CameraFleet


def test_a_fleet_that_takes_a_camera_renders_the_configured_one(tiny, monkeypatch):
    from cilrs_tpu_torch.bench import env_steps

    monkeypatch.setattr(env_steps, "BenchFleet", _fleet_with_camera())
    ctx = tiny("fleet128.benchtown")
    ctx.config["sim"]["camera"] = {"height": 48, "width": 96}
    driver = harness.load_module("drivers", "fleet")
    orig, shapes = driver.simrun.record_chunk, []

    def recorded(chunk, owner):
        ticks, hashes = orig(chunk, owner)
        shapes.extend(tuple(t["frame"].shape) for t in ticks)
        return ticks, hashes

    monkeypatch.setattr(driver.simrun, "record_chunk", recorded)
    out = driver.run(ctx)
    checked = harness.check_line(out["checked"])
    assert all(c["ok"] for c in checked.values()), checked
    assert out["checked"]["frame_gap"][0] == 0.0
    assert set(shapes) == {(2, 48, 96, 3)}


def test_a_fleet_without_a_camera_refuses_another(tiny):
    ctx = tiny("fleet128.benchtown")
    ctx.config["sim"]["camera"] = {"height": 48, "width": 96}
    with pytest.raises(ValueError, match="has no cam field"):
        harness.load_module("drivers", "fleet").run(ctx)
