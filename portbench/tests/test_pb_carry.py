"""A policy that carries state from tick to tick needs only new files: a
carrying stub architecture in a temporary ``policies/<arch>.py`` (the stub
conv policy of ``test_pb_arch.py`` plus a PID-like window of its last 8
steers, whose mean it adds to its steer) drives correct fleet and drive
windows, with its carry recorded before and after each tick, handed to the
reference policy and compared as ``carry_gap``. It comes out not correct
when it forgets its carry, when half of the batch is left out and when its
steer is altered. The faults pass a policy's keyword arguments through, and
``half`` cuts the tensor ones. The CILRS carries nothing and reads no
``carry_gap``."""

from __future__ import annotations

import contextlib
import copy
import os
import sys
import types

import pytest
import torch

from portbench import faults, harness
from portbench.trace import patched
from test_pb_arch import STUB_SOURCE, _harness_files

STUB = "stub_carry_pb"
# The stub conv policy, with ``program`` and ``reference_policy`` redefined
# below for its window of steers, and the ``carry`` hook.
STUB_CARRY_SOURCE = STUB_SOURCE + '''

WINDOW = 8  # the steers the window keeps, as a PID's integral keeps its errors


def _step(out, window):
    """The controls with the window's mean added to the steer, and the window
    with the net's steer appended."""
    steer = out[:, 0]
    nxt = torch.cat([window[:, 1:], steer[:, None]], 1)
    return torch.cat([(steer + window.mean(1))[:, None], out[:, 1:]], 1), nxt


class Carrying:
    """The stub's program policy with its window [E, WINDOW], made at its first
    call and updated in place; a call on fewer envs updates their rows."""

    def __init__(self, model):
        self.model = model
        self.carried = None

    def __call__(self, image, speed_norm, cmd):
        out = self.model(image, speed_norm, cmd)
        if self.carried is None:
            self.carried = {"steers": out.new_zeros(out.shape[0], WINDOW)}
        window = self.carried["steers"][:out.shape[0]]
        out, nxt = _step(out, window)
        window.copy_(nxt)
        return out


def program(model_cfg, sd, device, fp32=False):
    """The stub on the device with ``sd``, and its carrying fleet policy."""
    model = StubNet(model_cfg["channels"]).to(device).eval()
    model.load_state_dict(sd)
    return model, Carrying(model)


def carry(policy):
    """The policy's window, as it stands."""
    return policy.carried


def reference_policy(model, frame01, obs, state, pool, carry):
    """The stub's controls from ``carry``'s window, and the window after the tick."""
    speed = torch.clamp(obs["speed_kmh"] / SPEED_NORM_FACTOR, 0.0, 1.0)
    out, nxt = _step(model(normalize(frame01), speed, obs["cmd"]), carry["steers"])
    return out, {"steers": nxt}
'''
STUB_MODEL = {"arch": STUB, "channels": [8, 16]}
# The limit this test holds ``carry_gap`` to: the program's and the
# reference's steers are float32 over the same frame on the CPU.
CARRY_LIMIT = 1e-4


@pytest.fixture(scope="module")
def stub():
    """The carrying stub's file in ``policies/`` while the module's tests run;
    the harness's files are as they were once it is gone."""
    path = os.path.join(harness.PB_DIR, "policies", f"{STUB}.py")
    before = _harness_files()
    with open(path, "w") as f:
        f.write(STUB_CARRY_SOURCE)
    try:
        yield harness.architecture(STUB_MODEL)
    finally:
        os.remove(path)
        sys.modules.pop(f"portbench.policies.{STUB}", None)
        assert _harness_files() == before


def _stub_ctx(tiny, cell: str):
    ctx = tiny(cell)
    ctx.config["model"] = copy.deepcopy(STUB_MODEL)
    ctx.workload["limits"]["carry_gap"] = CARRY_LIMIT
    return ctx


def _by_keyword(f):
    """The policy ``f`` called with the command as a keyword argument, as a
    policy's target point would be handed to it."""
    return lambda image, speed_norm, cmd: f(image, speed_norm, cmd=cmd)


def _run(ctx, monkeypatch, fault=None, keyword=False):
    """The cell's run, with ``fault`` under its check's chunk (and with
    ``keyword`` the fault called with the command by keyword); returns the
    run and the recorded ticks."""
    driver = harness.load_module("drivers", ctx.workload["driver"])
    orig, recorded = driver.simrun.record_chunk, []

    def record(chunk, owner):
        with contextlib.ExitStack() as stack:
            if fault:
                stack.enter_context(faults.sim_fault(fault, owner))
            if keyword:
                stack.enter_context(patched(owner, "policy", _by_keyword))
            ticks, hashes = orig(chunk, owner)
        recorded.extend(ticks)
        return ticks, hashes

    monkeypatch.setattr(driver.simrun, "record_chunk", record)
    return driver.run(ctx), recorded


@pytest.mark.parametrize("cell,keyword", [("fleet128.benchtown", False),
                                          ("fleet128.benchtown", True),
                                          ("drive1.town01", False)])
def test_the_carrying_stub_drives_a_correct_window(stub, tiny, monkeypatch, cell, keyword):
    ctx = _stub_ctx(tiny, cell)
    out, ticks = _run(ctx, monkeypatch, keyword=keyword)
    checked = harness.check_line(out["checked"])
    assert all(c["ok"] for c in checked.values()), checked
    assert out["attempted"] >= 1 and out["failed"] == 0
    envs = ctx.traffic.get("envs", 1)
    for t in ticks:
        assert t["carry"]["steers"].shape == t["carry_next"]["steers"].shape == (envs, 8)
    # Each tick's carry after is the next tick's before: the record follows
    # the policy's own window, which moves every tick.
    for a, b in zip(ticks, ticks[1:]):
        assert torch.equal(a["carry_next"]["steers"], b["carry"]["steers"])
    assert not torch.equal(ticks[-1]["carry"]["steers"], ticks[-1]["carry_next"]["steers"])


@pytest.mark.parametrize("cell,fault,keyword", [("fleet128.benchtown", "forgetful", False),
                                                ("fleet128.benchtown", "half", False),
                                                ("fleet128.benchtown", "altered", False),
                                                ("fleet128.benchtown", "half", True),
                                                ("fleet128.benchtown", "altered", True),
                                                ("drive1.town01", "forgetful", False)])
def test_the_carrying_stub_with_a_fault_is_not_correct(stub, tiny, monkeypatch, cell, fault,
                                                       keyword):
    ctx = _stub_ctx(tiny, cell)
    out, _ = _run(ctx, monkeypatch, fault, keyword)
    checked = harness.check_line(out["checked"])
    assert not all(c["ok"] for c in checked.values()), checked
    if fault == "forgetful":  # the history it dropped shows in the carry's update
        assert not checked["carry_gap"]["ok"], checked


def test_forgetful_needs_a_carry():
    with pytest.raises(ValueError, match="carries state"):
        faults.sim_fault("forgetful", types.SimpleNamespace(policy=lambda *a: a[0]))


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_policy_with_a_keyword_tensor_runs_under_a_fault(fault):
    seen = []

    def policy(image, speed_norm, cmd, *, target):
        seen.append((image.shape[0], target.shape[0]))
        return torch.cat([image.mean((1, 2)), target], 1)[:, :3] + speed_norm[:, None] + cmd[:, None]

    owner = types.SimpleNamespace(policy=policy)
    args = (torch.rand(4, 6, 8, 3), torch.rand(4), torch.arange(4.0))
    target = torch.rand(4, 2)
    want = policy(*args, target=target)
    with faults.sim_fault(fault, owner):
        got = owner.policy(*args, target=target)
    assert owner.policy is policy
    if fault == "half":
        assert seen[-1] == (2, 2)
        assert torch.equal(got[:2], want[:2]) and not got[2:].any()
    else:
        assert seen[-1] == (4, 4)
        assert torch.equal(got[:, 0], want[:, 0] + 0.25) and torch.equal(got[:, 1:], want[:, 1:])


def test_the_cilrs_reads_no_carry_gap(tiny, monkeypatch):
    ctx = tiny("fleet128.benchtown")
    driver = harness.load_module("drivers", "fleet")
    orig, recorded = driver.simrun.record_chunk, []

    def record(chunk, owner):
        ticks, hashes = orig(chunk, owner)
        recorded.extend(ticks)
        return ticks, hashes

    monkeypatch.setattr(driver.simrun, "record_chunk", record)
    out = driver.calibrate(ctx, control=False)
    assert "carry_gap" not in out["program"]
    assert recorded and not any({"carry", "carry_next"} & t.keys() for t in recorded)
