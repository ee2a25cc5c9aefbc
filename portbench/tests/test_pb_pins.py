"""What the harness may not move in ``fleet128.benchtown`` at one seed, pinned
at the tiny size on the CPU: the seeded weights bit for bit, and the tiny
fleet run's check (its readings, and sums of the frames, controls and next
positions of the ticks it compared). A change to the weights' draw, the
fleet's start, its camera or its policy's inputs shows here."""

from __future__ import annotations

import hashlib

import torch

from portbench import harness
from portbench.weights import seeded_state_dict

SEED = 2 ** 31 + 12345
WEIGHTS_SHA256 = "2b2b0ec44ca338e53e267c0cfa6bbd809f693929c71eebe7adaf81a56dde9fe6"
CHECKED = {"frame_gap": 0.0, "controls_rms": 0.0, "act_gap": 0.0, "start_mismatch": 0}
# Sums over the check's ticks: frames, |controls|, next vehicle positions.
SUMS = {"frames": 138578.05451227725, "controls": 2.0584551952779293,
        "next": 14236.919122695923}


def test_seeded_weights_are_pinned(tiny):
    ctx = tiny("fleet128.benchtown", seed=SEED)
    sd = seeded_state_dict(ctx.config["model"], ctx.seed_for(2), torch.device("cpu"))
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().tobytes())
    assert len(sd) == 107 and h.hexdigest() == WEIGHTS_SHA256


def test_tiny_fleet_check_is_pinned(tiny, monkeypatch):
    ctx = tiny("fleet128.benchtown", seed=SEED)
    driver = harness.load_module("drivers", "fleet")
    orig, sums = driver.simrun.record_chunk, {}

    def recorded(chunk, owner):
        ticks, hashes = orig(chunk, owner)
        sums.update(frames=sum(float(t["frame"].double().sum()) for t in ticks),
                    controls=sum(float(t["controls"].double().abs().sum()) for t in ticks),
                    next=sum(float(t["next"].world.veh_pos.double().sum()) for t in ticks))
        return ticks, hashes

    monkeypatch.setattr(driver.simrun, "record_chunk", recorded)
    out = driver.run(ctx)
    assert out["attempted"] == 1
    assert {k: v for k, (v, _) in out["checked"].items()} == CHECKED
    for k, want in SUMS.items():  # CPU sums may round apart by a few units in the last place
        assert abs(sums[k] - want) <= 1e-9 * abs(want), (k, sums[k], want)
