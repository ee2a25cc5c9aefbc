"""Drawn inputs of the port's safety cascade (``agent/controller.py``) for
its graph's tests (no JAX: the card's tests import this too): a two-lane
town, then chained ticks (the draws of tests/test_torch_drive.py's
``_controller_cases``, over the fleet at once) in which, at 128 envs over
60 ticks, every status 0-7 and every event occurs."""

import numpy as np
import torch

from cilrs_tpu_torch.agent import controller as tctl
from cilrs_tpu_torch.core.state import make_world, tree_leaves
from cilrs_tpu_torch.maps.town import make_town01
from cilrs_tpu_torch.ops.filters import SmoothingState

V, P = 4, 2  # vehicles (the ego at 0), pedestrians


def two_lane_town():
    """A 2x2-block town with two lanes a direction (overtakes need one)."""
    return make_town01(blocks_x=2, blocks_y=2, block_m=80.0, lanes_per_dir=2, tex_scale=1.0)


def draw_ctrl(envs: int, r: np.random.RandomState, now: float, device="cpu") -> tctl.CtrlState:
    """Controller memories at ``now``: timers idle or running, every
    overtake state, phases around each boundary."""
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    ago = lambda p, lo, hi: np.where(r.rand(envs) < p, tctl.T_NONE, now - r.uniform(lo, hi, envs))
    el = r.choice([0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5, 3.0], envs) + r.uniform(-0.2, 0.2, envs)
    return tctl.CtrlState(
        smoothing=SmoothingState(steer_buf=t(r.uniform(-0.5, 0.5, (envs, 5))),
                                 throttle_buf=t(r.uniform(0.0, 1.0, (envs, 5))),
                                 count=t(r.randint(0, 6, envs), torch.int64)),
        waiting_for_red=t(r.rand(envs) < 0.3, torch.bool),
        red_clear_time=t(now - r.uniform(0.0, 20.0, envs)),
        waiting_for_traffic=t(r.rand(envs) < 0.3, torch.bool),
        traffic_wait_start=t(ago(0.5, 0.0, 30.0)),
        obstacle_wait_start=t(ago(0.3, 3.0, 12.0)),
        stopped_start=t(ago(0.4, 0.0, 8.0)),
        ov_state=t(r.choice(4, envs, p=[0.4, 0.2, 0.1, 0.3]), torch.int64),
        ov_start=t(now - el),
    )


def draw_tick(net, envs: int, r: np.random.RandomState, now: float, device="cpu"):
    """One tick's world (the fields the cascade reads drawn, egos on lanes
    with and without a same-direction neighbour, that lane blocked or
    clear) and its inputs after ``ctrl``: (nn_steer, nn_gas, nn_brake,
    speed_kmh, cmd, hint, obs_dist, tl_state, red_ahead)."""
    h = net.host
    two = np.nonzero((h.wp_left >= 0) | (h.wp_right >= 0))[0]
    wp = np.where(np.arange(envs) % 3 > 0, r.choice(two, envs), r.randint(len(h.wp_xy), size=envs))
    yaw = h.wp_yaw[wp]
    fwd = np.stack([np.cos(yaw), np.sin(yaw)], -1)
    pos = np.zeros((envs, V, 2))
    pos[:, 0] = h.wp_xy[wp] + r.uniform(-0.5, 0.5, (envs, 2))
    adj = np.maximum(h.wp_left[wp], h.wp_right[wp])
    # v1 in the neighbouring lane (blocking it about half the time), v2
    # ahead in the ego's lane, v3 far away.
    base = np.where((adj >= 0)[:, None], h.wp_xy[np.maximum(adj, 0)], pos[:, 0])
    pos[:, 1] = base + fwd * r.uniform(-8.0, 40.0, (envs, 1))
    pos[:, 2] = pos[:, 0] + fwd * r.uniform(2.0, 12.0, (envs, 1))
    pos[:, 3] = pos[:, 0] + 300.0
    ped = np.stack([pos[:, 0] + fwd * r.uniform(-10, 40, (envs, 1)) + r.uniform(-6, 6, (envs, 2)),
                    pos[:, 0] - 200.0], 1)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    world = make_world(envs, V, P, device=device).replace(
        veh_pos=t(pos), veh_alive=t(np.stack([np.ones(envs, bool), r.rand(envs) < 0.7,
                                              np.ones(envs, bool), np.ones(envs, bool)], 1),
                                    torch.bool),
        ped_pos=t(ped),
        ped_alive=t(np.stack([r.rand(envs) < 0.4, np.ones(envs, bool)], 1), torch.bool),
        time_s=t(np.full(envs, now)), weather_idx=t(r.randint(0, 5, envs), torch.int64))
    stall = r.rand(envs) < 0.5
    obs = (t(r.uniform(-0.8, 0.8, envs)), t(r.uniform(0, 1, envs)), t(r.uniform(0, 1, envs)),
           t(np.where(stall, r.uniform(0, 2.5, envs), r.uniform(0, 70, envs))),
           t(r.randint(0, 4, envs), torch.int64), t(r.uniform(-0.6, 0.6, envs)),
           t(np.where(r.rand(envs) < 0.3, 999.0, r.uniform(0.5, 35.0, envs))),
           t(r.choice(4, envs, p=[0.3, 0.15, 0.15, 0.4]), torch.int64),
           t(r.rand(envs) < 0.15, torch.bool))
    return world, obs


def chained_ticks(net, envs: int, ticks: int, seed: int = 0, device="cpu"):
    """(first CtrlState, [(world, obs)] a tick): ``ticks`` ticks 0.05-1.5 s
    apart, so the overtake and reverse phases pass within them."""
    r = np.random.RandomState(seed)
    now = 30.0
    ctrl = draw_ctrl(envs, r, now, device)
    out = []
    for _ in range(ticks):
        now += r.uniform(0.05, 1.5)
        out.append(draw_tick(net, envs, r, now, device))
    return ctrl, out


def outputs_equal(got, want) -> bool:
    """Every tensor of two (control, reverse, status, CtrlState, events)
    results equal, dtypes and shapes included."""
    flat = lambda out: [*out[:3], *tree_leaves(out[3]), *out[4].values()]
    g, w = flat(got), flat(want)
    return (list(got[4]) == list(want[4]) and len(g) == len(w)
            and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(g, w)))
