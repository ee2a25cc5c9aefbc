"""``agent/controller.py:safety_controller`` off the card: the eager cascade
as it is, bit for bit, and no CUDA graph captured; which calls would replay
a graph on the card, what a graph is captured for, and the packing of the
cascade's outputs that a replay clones out in one buffer. The card's
replays are tested in ``tests/test_torch_cuda.py``."""

import dataclasses
import types

import pytest
import torch

from cilrs_tpu_torch import config as tc
from cilrs_tpu_torch.agent import controller as tctl
from cilrs_tpu_torch.utils.profiling import span
from torch_safety_cases import chained_ticks, outputs_equal, two_lane_town

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def town():
    return two_lane_town()


@pytest.mark.parametrize("envs", [1, 16])
def test_cpu_safety_controller_is_the_cascade_bit_for_bit(town, envs):
    wt = tc.load_weather_table()
    ctrl, ticks = chained_ticks(town, envs, 20, seed=envs)
    statuses = set()
    for world, obs in ticks:
        got = tctl.safety_controller(town, world, ctrl, wt, *obs)
        want = tctl.safety_cascade(town, world, ctrl, wt, *obs)
        assert outputs_equal(got, want)
        statuses |= set(got[2].tolist())
        ctrl = got[3]
    if envs > 1:  # the ticks reach the cascade's branches
        assert len(statuses) >= 6, sorted(statuses)


def test_cpu_safety_controller_captures_no_graph(town):
    wt = tc.load_weather_table()
    before = dict(tctl.GRAPHS)
    replays, captures = span("safety_graph").calls, span("safety_capture").calls
    for envs in (2, 3, 2):
        ctrl, ticks = chained_ticks(town, envs, 2, seed=envs)
        for world, obs in ticks:
            ctrl = tctl.safety_controller(town, world, ctrl, wt, *obs)[3]
    assert tctl.GRAPHS == before
    assert span("safety_graph").calls == replays and span("safety_capture").calls == captures


@pytest.mark.parametrize("envs", [1, 16])
def test_packed_outputs_unpack_to_the_cascade(town, envs):
    """What a replay clones out, one buffer of every output's bytes, unpacks
    to the eager cascade's outputs bit for bit, each view aligned to its
    element."""
    wt = tc.load_weather_table()
    ctrl, ticks = chained_ticks(town, envs, 3, seed=envs + 1)
    for world, obs in ticks:
        inputs = tctl.graph_inputs(world, ctrl, *obs)
        flat, layout, names = tctl._packed_cascade(town, wt, ctrl)(*inputs)
        assert flat.dtype == torch.uint8 and flat.dim() == 1
        got = tctl._unpacked(ctrl, flat.clone(), layout, names)
        want = tctl.safety_cascade(town, world, ctrl, wt, *obs)
        assert outputs_equal(got, want)
        for dtype, a, b, *_ in layout:
            assert a % dtype.itemsize == 0 and b % dtype.itemsize == 0
        ctrl = want[3]


# (every input on the card, one input requiring grad, one input on the CPU)
GRAPHABLE = {
    "card": (True, False, False, True),
    "card_grad": (True, True, False, False),
    "card_one_cpu_input": (True, False, True, False),
    "cpu": (False, False, False, False),
}


@pytest.mark.parametrize("case", sorted(GRAPHABLE))
def test_only_card_inputs_without_grad_replay(case):
    card, grad, one_cpu, want = GRAPHABLE[case]
    # Stand-ins for card tensors: ``graphable`` reads only ``is_cuda`` and
    # ``requires_grad``.
    inputs = [types.SimpleNamespace(is_cuda=card, requires_grad=False) for _ in range(26)]
    if grad:
        inputs[20] = types.SimpleNamespace(is_cuda=True, requires_grad=True)
    if one_cpu:
        inputs[7] = torch.zeros(1)
    assert tctl.graphable(inputs) is want


def test_inputs_requiring_grad_run_the_eager_cascade(town):
    wt = tc.load_weather_table()
    ctrl, ticks = chained_ticks(town, 4, 1)
    world, obs = ticks[0]
    steer = obs[0].clone().requires_grad_()
    got = tctl.safety_controller(town, world, ctrl, wt, steer, *obs[1:])
    want = tctl.safety_cascade(town, world, ctrl, wt, steer, *obs[1:])
    assert not tctl.graphable(tctl.graph_inputs(world, ctrl, steer, *obs[1:]))
    assert got[0].requires_grad
    assert torch.equal(got[0], want[0])


def test_graph_key_separates_fleet_sizes_dtypes_networks_and_tables(town):
    wt = tc.load_weather_table()

    def key(envs, seed=0, net=town, table=wt, cast=None):
        ctrl, ticks = chained_ticks(town, envs, 1, seed=seed)
        world, obs = ticks[0]
        if cast is not None:
            obs = (*obs[:5], obs[5].to(cast), *obs[6:])
        return tctl.graph_key(net, table, tctl.graph_inputs(world, ctrl, *obs))

    base = key(128)
    assert key(128, seed=1) == base  # other values, the same graph
    others = [key(64), key(1), key(128, cast=torch.float64), key(128, cast=torch.bfloat16),
              key(128, net=dataclasses.replace(town)), key(128, table=dataclasses.replace(wt))]
    assert len({base, *others}) == 1 + len(others)
