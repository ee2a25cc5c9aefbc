"""Parity of the port's closed loop in drive mode with the JAX package: the
safety controller and its overtake/reverse machine, ``can_overtake`` on a
two-lane network, the drive-mode ``fleet_rollout`` tick by tick (looping
routes, a pinned destination reached inside the run, the departure hold),
one tick with a real CILRS policy, the scores and the terminal report, and
the drive and benchmark CLIs on the CPU.

JAX's PRNG and torch's generators draw different streams, so the pedestrians'
re-aim runs on JAX's own draws (as in tests/test_torch_agent.py). The stub
policy reads the frame (its mean), so the renderer feeds the controls.

Tolerances:
 - ``safety_controller`` on 320 drawn cases: statuses, the reverse flag,
   events and the new ``CtrlState``'s flags, timers, overtake state and
   smoothing count exact; the pushed steer and throttle in its smoothing
   buffers within 1e-6, the controls within 1e-5 (XLA fuses multiply-adds,
   torch rounds each product);
 - the drive rollouts: integers (commands, statuses, light states, route
   indices, teleport causes, completions) exact; poses within 1e-4 m and
   1e-5 rad, speeds 1e-4 km/h, controls 1e-5; the u8 frames within the
   renderer's tolerance (at most 0.5% of the values off by more than 1, mean
   difference under 0.05); metrics within 1e-4;
 - one tick with a real CILRS (stage_sizes (1, 1, 1, 1), float32 on both
   sides): controls within 1e-3, the tolerance of tests/test_torch_model.py
   (both packages round the branch heads' first product to bf16);
 - ``compute_scores`` within 1e-4 of its value, ``format_report`` equal;
 - ``DashboardHUD.compose``: the same canvas, exactly (both packages draw
   with the same OpenCV calls);
 - ``cli.drive --view chase --save-video``: an mp4 that OpenCV reads back,
   one frame a chunk.
"""

import argparse
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu import config as jc  # noqa: E402
from cilrs_tpu.agent import controller as jctl  # noqa: E402
from cilrs_tpu.agent import driver as jd  # noqa: E402
from cilrs_tpu.agent import scenario as jsc  # noqa: E402
from cilrs_tpu.cli import benchmark as j_bench  # noqa: E402
from cilrs_tpu.core.state import default_vehicle_params as j_params  # noqa: E402
from cilrs_tpu.core.state import make_world as j_make_world  # noqa: E402
from cilrs_tpu.evaluation import scoring as jscore  # noqa: E402
from cilrs_tpu.evaluation.metrics import init_metrics as j_init_metrics  # noqa: E402
from cilrs_tpu.maps import routing as jr  # noqa: E402
from cilrs_tpu.maps import town as jt  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu_torch import config as tc  # noqa: E402
from cilrs_tpu_torch.agent import controller as tctl  # noqa: E402
from cilrs_tpu_torch.agent import driver as td  # noqa: E402
from cilrs_tpu_torch.cli import benchmark as bench_cli  # noqa: E402
from cilrs_tpu_torch.cli import drive as drive_cli  # noqa: E402
from cilrs_tpu_torch.core.convert import (driver_state_from_arrays, pool_from_arrays,  # noqa: E402
                                          world_from_arrays)
from cilrs_tpu_torch.core.state import default_vehicle_params as t_params  # noqa: E402
from cilrs_tpu_torch.evaluation import scoring as tscore  # noqa: E402
from cilrs_tpu_torch.maps import routing as tr  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402
from cilrs_tpu_torch.train.checkpoint import save_checkpoint_pth  # noqa: E402

CTRL_TOL = dict(atol=1e-5, rtol=0)
ROLL_TOL = {"pos": 1e-4, "speed_kmh": 1e-4, "obstacle_dist": 1e-4}
FRAME_MAX_SHARE = 0.005
FRAME_MAX_MEAN = 0.05
CAM = dict(width=64, height=32)
N_CASES = 320


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy)
    (``cilrs_tpu/maps/routing.py:155-164``): a network freed by an earlier test
    can hand its id, and so its graph, to a new one. Each test here starts and
    ends with that cache empty."""
    jr._graph_cache.clear()
    yield
    jr._graph_cache.clear()


def tree_np(x):
    """A JAX state as nested dicts of (writable) numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "host"}
    return np.array(x)


def stack(trees):
    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


def assert_tree_equal(got, want, name="", close=(), atol=0.0):
    """A port TensorTree against the JAX one's numpy dict: exactly, but the
    leaves named in ``close``, which must agree within ``atol``."""
    if isinstance(want, dict):
        for k in want:
            assert_tree_equal(getattr(got, k), want[k], f"{name}.{k}", close, atol)
    elif name.split(".")[-1] in close:
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0, err_msg=name)
    else:
        g = got.numpy()
        np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=name)


@pytest.fixture(scope="module")
def twolane():
    kw = dict(blocks_x=2, blocks_y=2, block_m=80.0, lanes_per_dir=2, tex_scale=1.0)
    return jt.make_town01(**kw), tt.make_town01(**kw)


# ---------------------------------------------------------------------------
# safety_controller and can_overtake
# ---------------------------------------------------------------------------


def _controller_cases(tnet, n=N_CASES, seed=0):
    """n drawn (world, ctrl, inputs) cases as numpy, chosen so that every
    status 0-7 and every overtake and reverse phase occurs: egos on lanes
    with and without a same-direction neighbour, that lane blocked or clear,
    timers running or idle at every phase boundary."""
    h = tnet.host
    r = np.random.RandomState(seed)
    two = np.nonzero((h.wp_left >= 0) | (h.wp_right >= 0))[0]
    V, P = 4, 2
    worlds, ctrls, inputs = [], [], []
    for e in range(n):
        wp = int(r.choice(two) if e % 3 else r.randint(len(h.wp_xy)))
        yaw = float(h.wp_yaw[wp])
        fwd = np.array([np.cos(yaw), np.sin(yaw)], np.float32)
        now = np.float32(r.uniform(20.0, 200.0))
        pos = np.zeros((V, 2), np.float32)
        pos[0] = h.wp_xy[wp] + r.uniform(-0.5, 0.5, 2)
        adj = max(int(h.wp_left[wp]), int(h.wp_right[wp]))
        # v1 in the neighbouring lane (blocking it about half the time), v2
        # ahead in the ego's lane, v3 far away.
        pos[1] = (h.wp_xy[adj] if adj >= 0 else pos[0]) + fwd * r.uniform(-8.0, 40.0)
        pos[2] = pos[0] + fwd * r.uniform(2.0, 12.0)
        pos[3] = pos[0] + 300.0
        ped = np.stack([pos[0] + fwd * r.uniform(-10, 40) + r.uniform(-6, 6, 2),
                        pos[0] - 200.0]).astype(np.float32)
        worlds.append({
            "veh_pos": pos, "veh_yaw": np.full(V, yaw, np.float32),
            "veh_alive": np.array([True, r.rand() < 0.7, True, True]),
            "ped_pos": ped, "ped_alive": np.array([r.rand() < 0.4, True]),
            "time_s": now, "weather_idx": np.int64(e % 5)})
        t_or_idle = lambda p, lo, hi: np.float32(
            jctl.T_NONE if r.rand() < p else now - np.float32(r.uniform(lo, hi)))
        el = r.choice([0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5, r.uniform(0.0, 8.0)])
        ctrls.append({
            "smoothing": {"steer_buf": r.uniform(-0.5, 0.5, 5).astype(np.float32),
                          "throttle_buf": r.uniform(0.0, 1.0, 5).astype(np.float32),
                          "count": np.int64(r.randint(0, 6))},
            "waiting_for_red": np.bool_(r.rand() < 0.3),
            "red_clear_time": np.float32(now - np.float32(r.uniform(0.0, 20.0))),
            "waiting_for_traffic": np.bool_(r.rand() < 0.3),
            "traffic_wait_start": t_or_idle(0.5, 0.0, 30.0),
            "obstacle_wait_start": t_or_idle(0.3, 3.0, 12.0),
            "stopped_start": t_or_idle(0.4, 0.0, 8.0),
            "ov_state": np.int64(r.choice(4, p=[0.4, 0.2, 0.1, 0.3])),
            "ov_start": np.float32(now - np.float32(el)),
        })
        stall = r.rand() < 0.5
        inputs.append({
            "nn": np.array([r.uniform(-0.8, 0.8), r.uniform(0, 1), r.uniform(0, 1)], np.float32),
            "speed": np.float32(r.uniform(0, 2.5) if stall else r.uniform(0, 70)),
            "cmd": np.int64(r.randint(4)), "hint": np.float32(r.uniform(-0.6, 0.6)),
            "obs": np.float32(999.0 if r.rand() < 0.3 else r.uniform(0.5, 35.0)),
            "tl": np.int64(r.choice(4, p=[0.3, 0.15, 0.15, 0.4])),
            "red_ahead": np.bool_(r.rand() < 0.15)})
        if e % 8 == 1:  # stopped behind an obstacle past the wait: the trigger
            worlds[-1]["veh_alive"][1] = worlds[-1]["ped_alive"][0] = False
            ctrls[-1].update(ov_state=np.int64(tctl.OV_NONE),
                             obstacle_wait_start=np.float32(now - np.float32(r.uniform(4.5, 10.0))),
                             red_clear_time=np.float32(now - 15.0))
            inputs[-1].update(speed=np.float32(r.uniform(0, 2.5)), obs=np.float32(6.0),
                              tl=np.int64(3), red_ahead=np.bool_(False))
    stacked = lambda items: {k: np.stack([it[k] for it in items]) for k in items[0]}
    ctrl = {k: stacked([c[k] for c in ctrls]) if k == "smoothing" else np.stack([c[k] for c in ctrls])
            for k in ctrls[0]}
    return stacked(worlds), ctrl, stacked(inputs)


def _jax_world(w):
    n = len(w["time_s"])
    base = jax.vmap(lambda _: j_make_world(4, 2))(jnp.arange(n))
    return base.replace(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                           for k, v in w.items()})


def _torch_world(w):
    n = len(w["time_s"])
    from cilrs_tpu_torch.core.state import make_world
    base = make_world(n, 4, 2)
    return base.replace(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in w.items()})


def _jax_ctrl(c):
    from cilrs_tpu.ops.filters import SmoothingState
    cast = lambda v: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
    return jctl.CtrlState(smoothing=SmoothingState(**{k: cast(v) for k, v in c["smoothing"].items()}),
                          **{k: cast(v) for k, v in c.items() if k != "smoothing"})


def _torch_ctrl(c):
    from cilrs_tpu_torch.ops.filters import SmoothingState
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    return tctl.CtrlState(smoothing=SmoothingState(**{k: t(v) for k, v in c["smoothing"].items()}),
                          **{k: t(v) for k, v in c.items() if k != "smoothing"})


def test_safety_controller_matches_jax(twolane):
    jnet, tnet = twolane
    w, c, x = _controller_cases(tnet)
    jwt, twt = jc.load_weather_table(), tc.load_weather_table()
    want = jax.jit(jax.vmap(
        lambda wo, ct, nn, sp, cm, hi, ob, tl, ra: jctl.safety_controller(
            jnet, wo, ct, jwt, nn[0], nn[1], nn[2], sp, cm, hi, ob, tl, red_ahead=ra)))(
        _jax_world(w), _jax_ctrl(c), x["nn"], x["speed"], x["cmd"].astype(np.int32), x["hint"],
        x["obs"], x["tl"].astype(np.int32), x["red_ahead"])
    t = lambda k: torch.from_numpy(x[k])
    got = tctl.safety_controller(tnet, _torch_world(w), _torch_ctrl(c), twt,
                                 t("nn")[:, 0], t("nn")[:, 1], t("nn")[:, 2], t("speed"),
                                 t("cmd"), t("hint"), t("obs"), t("tl"), t("red_ahead"))
    (jctrl_, jrev, jst, jnew, jev), (gctrl, grev, gst, gnew, gev) = want, got
    np.testing.assert_allclose(gctrl.numpy(), np.asarray(jctrl_), **CTRL_TOL)
    np.testing.assert_array_equal(grev.numpy(), np.asarray(jrev))
    np.testing.assert_array_equal(gst.numpy(), np.asarray(jst))
    assert_tree_equal(gnew, tree_np(jnew), "ctrl", close=("steer_buf", "throttle_buf"), atol=1e-6)
    assert set(gev) == set(jev)
    for k in jev:
        np.testing.assert_array_equal(gev[k].numpy(), np.asarray(jev[k]), err_msg=k)

    # Coverage, read off the reference: every status of the cascade, every
    # overtake and reverse phase.
    st = np.asarray(jst)
    assert set(range(8)) <= set(st.tolist()), sorted(set(st.tolist()))
    el = w["time_s"] - c["ov_start"]
    ov0, ov1 = c["ov_state"], np.asarray(jnew.ov_state)
    lane = (ov0 == tctl.OV_LEFT) | (ov0 == tctl.OV_RIGHT)
    for phase, lo, hi in (("change", 0, 2), ("pass", 2, 5), ("return", 5, 7)):
        assert (lane & (el >= lo) & (el < hi) & (st >= tctl.ST_OVERTAKE_L)
                & (st <= tctl.ST_OVERTAKE_R)).any(), phase
    assert (lane & (el > 7) & (ov1 == tctl.OV_NONE)).any(), "lane change done"
    rev = ov0 == tctl.OV_REVERSE
    assert (rev & (st == tctl.ST_REVERSE)).any(), "backing"
    assert (rev & (el >= 3) & (el <= 5) & ((ov1 == tctl.OV_LEFT) | (ov1 == tctl.OV_RIGHT))).any(), \
        "retry found a lane"
    assert np.asarray(jev["teleport_request"]).any(), "reverse gave up"
    started = (ov0 == tctl.OV_NONE) & (ov1 != tctl.OV_NONE)
    assert (started & (ov1 == tctl.OV_REVERSE)).any() and (started & (ov1 != tctl.OV_REVERSE)).any()


def test_can_overtake_matches_jax(twolane):
    jnet, tnet = twolane
    w, _, _ = _controller_cases(tnet, n=96, seed=1)
    want = jax.jit(jax.vmap(lambda wo: jctl.can_overtake(jnet, wo)))(_jax_world(w))
    got = tctl.can_overtake(tnet, _torch_world(w))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    left, right = (np.asarray(v) for v in want)
    assert left.any() and right.any() and (~left & ~right).any()


# ---------------------------------------------------------------------------
# The drive rollout
# ---------------------------------------------------------------------------


def _stub_jax(img, speed_norm, cmd):
    m = jnp.tanh(jnp.mean(img, axis=(1, 2, 3)))
    return jnp.stack([0.1 * m, 0.5 + 0.1 * m, 0.3 + 0.2 * m], axis=-1)


def _stub_torch(img, speed_norm, cmd):
    m = torch.tanh(img.mean(dim=(1, 2, 3)))
    return torch.stack([0.1 * m, 0.5 + 0.1 * m, 0.3 + 0.2 * m], dim=-1)


def _drive_fleet(jnet, tnet, scenario, E=2):
    """E envs as collect_session sets them up, in drive mode. 'destination':
    each env's pool is one route, traced with the JAX tracer and the port's
    from the ego's waypoint to a waypoint about 24 m down its first chained
    route, and the ego starts at 7 m/s, so it arrives inside the run."""
    rng = np.random.RandomState(4)
    jpools, tpools, states = [], [], []
    for e in range(E):
        pool, meta = jr.chained_route_pool(jnet, rng, num_routes=3, min_dist=40.0,
                                           max_dist=250.0, with_meta=True)
        w = jsc.spawn_world(jnet, 4, 2, rng, weather_idx=(0, 3)[e % 2], seed=e)
        s = meta["start_wps"][0]
        xy, yaw = np.asarray(jnet.wp_xy)[s], float(np.asarray(jnet.wp_yaw)[s])
        w = w.replace(veh_pos=w.veh_pos.at[0].set(jnp.asarray(xy)),
                      veh_yaw=w.veh_yaw.at[0].set(yaw), rng=jax.random.PRNGKey(e))
        if scenario == "destination":
            dest = int(np.asarray(pool.wp_index)[0, 12])
            jroute, troute = jr.trace_route(jnet, s, dest), tr.trace_route(tnet, s, dest)
            pool = jr.stack_routes([jroute])
            tpools.append({k: v[None] for k, v in troute.items()})
            w = w.replace(veh_speed=w.veh_speed.at[0].set(7.0))
        else:
            tpools.append(tree_np(pool))
        jpools.append(pool)
        states.append(jd.make_driver_state(w))
    return jpools, tpools, states


@functools.lru_cache(maxsize=None)
def _drive(scenario):
    """(JAX final state, JAX outputs, port final state, port outputs) of a
    drive-mode run of the scenario."""
    jnet, tnet = jt.make_mini_town(), tt.make_mini_town()
    T = {"looping": 50, "destination": 60, "hold": 40}[scenario]
    kw = dict(loop_routes=scenario != "destination",
              hold_until_s=1.0 if scenario == "hold" else 0.0)
    jpools, tpools, states = _drive_fleet(jnet, tnet, scenario)
    jstate, jpool = stack(states), stack(jpools)
    wt, params = jc.load_weather_table(), j_params()
    final, want = jax.jit(jax.vmap(lambda s, p: jd.rollout(
        s, T, jnet, p, wt, params, _stub_jax, mode="drive", cam=JCam(**CAM), want_frames=True,
        **kw)))(jstate, jpool)
    draws = torch.tensor(_jax_draws(jstate.world.rng, T, 2))
    got_final, got = td.fleet_rollout(
        driver_state_from_arrays([tree_np(s) for s in states]), T, tnet, pool_from_arrays(tpools),
        tc.load_weather_table(), t_params(), draws, mode="drive", cam=CameraSpec(**CAM),
        policy=_stub_torch, **kw)
    return final, {k: np.asarray(v) for k, v in want.items()}, got_final, \
        {k: v.numpy() for k, v in got.items()}


def _jax_draws(keys, steps, P):
    """The uniforms of JAX's pedestrian re-aim, tick by tick: [T, E, P]."""
    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]
    return np.ascontiguousarray(np.asarray(jax.vmap(one)(keys)).transpose(1, 0, 2))


def _assert_outputs_match(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k == "frame":
            d = np.abs(g.astype(int) - w.astype(int))
            assert (d > 1).mean() <= FRAME_MAX_SHARE and d.mean() <= FRAME_MAX_MEAN, k
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=ROLL_TOL.get(k, 1e-5), rtol=0, err_msg=k)


@pytest.mark.parametrize("scenario", ["looping", "destination", "hold"])
def test_drive_rollout_matches_jax(scenario):
    final, want, got_final, got = _drive(scenario)
    _assert_outputs_match(got, want)
    np.testing.assert_array_equal(got_final.world.time_s.numpy(), np.asarray(final.world.time_s))
    np.testing.assert_array_equal(got_final.route_done.numpy(), np.asarray(final.route_done))
    for name, w in tree_np(final.metrics).items():
        np.testing.assert_allclose(getattr(got_final.metrics, name).numpy(), w, atol=1e-4,
                                   rtol=1e-6, err_msg=name)
    status = want["status"]
    assert (status != tctl.ST_RECOVERY).any()
    if scenario == "destination":
        # Arrival inside the run: one attempt, one completion, the car parked
        # from the tick after and the metrics frozen.
        done = want["completed"].any(axis=1)
        assert done.all()
        m = tree_np(final.metrics)
        np.testing.assert_array_equal(m["routes_attempted"], 1.0)
        np.testing.assert_array_equal(m["routes_completed"], 1.0)
        assert (m["total_frames"] < want["status"].shape[1]).all()
        arrive = want["completed"].argmax(axis=1)
        for e, k in enumerate(arrive):
            assert (want["speed_kmh"][e, k + 2:] == 0.0).all()
    elif scenario == "hold":
        held = want["control"][:, :20]
        np.testing.assert_array_equal(held[..., 1], 0.0)
        assert (want["speed_kmh"][:, 25:] > want["speed_kmh"][:, 19:20]).any()
    else:
        assert (np.asarray(final.metrics.total_distance) > 2.0).all()


def test_drive_tick_with_a_real_cilrs():
    """One drive tick with a small CILRS (perturbed JAX init) on both sides."""
    jnet, tnet = jt.make_mini_town(), tt.make_mini_town()
    jpools, tpools, states = _drive_fleet(jnet, tnet, "looping")
    jm = JCILRS(dropout=0.0, dtype=jnp.float32, speed_skip=True, stage_sizes=(1, 1, 1, 1))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CAM["height"], CAM["width"], 3)),
                jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    r = np.random.RandomState(1)
    v = jax.tree.map(lambda a: np.asarray(a) * r.uniform(0.9, 1.1, np.shape(a)).astype(np.float32)
                     + r.uniform(-0.05, 0.05, np.shape(a)).astype(np.float32), v)
    model = CILRS(dropout=0.0, dtype=torch.float32, stage_sizes=(1, 1, 1, 1), speed_skip=True)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    model.eval()

    def jpolicy(img, speed_norm, cmd):
        return jm.apply(v, img, speed_norm, cmd, train=False)[0]

    jstate, jpool = stack(states), stack(jpools)
    _, want = jax.jit(jax.vmap(lambda s, p: jd.rollout(
        s, 1, jnet, p, jc.load_weather_table(), j_params(), jpolicy, mode="drive",
        cam=JCam(**CAM), want_frames=True)))(jstate, jpool)
    _, got = td.fleet_rollout(
        driver_state_from_arrays([tree_np(s) for s in states]), 1, tnet, pool_from_arrays(tpools),
        tc.load_weather_table(), t_params(), torch.tensor(_jax_draws(jstate.world.rng, 1, 2)),
        mode="drive", cam=CameraSpec(**CAM), policy=td.model_policy(model))
    want = {k: np.asarray(w) for k, w in want.items()}
    np.testing.assert_allclose(got["control"].numpy(), want["control"], atol=1e-3, rtol=0)
    _assert_outputs_match({k: g.numpy() for k, g in got.items() if k != "control"},
                          {k: w for k, w in want.items() if k != "control"})
    assert np.abs(want["control"]).max() > 0.0


# ---------------------------------------------------------------------------
# Scores, the report and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["looping", "destination"])
def test_scores_and_report_match_jax(scenario):
    final, _, got_final, _ = _drive(scenario)
    jcfg, tcfg = jc.load_scoring_config(), tc.load_scoring_config()
    assert dataclasses.asdict(tcfg) == {k: (tuple(v) if k == "grades" else v)
                                        for k, v in dataclasses.asdict(jcfg).items()}
    for e in range(len(np.asarray(final.world.time_s))):
        want = jscore.compute_scores(jax.tree.map(lambda a: a[e], final.metrics), jcfg)
        got = tscore.compute_scores(got_final.metrics, tcfg, env=e)
        assert set(got) == set(want)
        for k, w in want.items():
            if isinstance(w, str):
                assert got[k] == w, k
            else:
                assert got[k] == pytest.approx(w, abs=1e-4), k
        assert tscore.format_report(got) == jscore.format_report(want)


def _mini_route_pair(tnet):
    """A (spawn, destination) pair of spawn-point indices of the mini town
    with a route of at least 40 waypoints (80 m) between them."""
    spawns = tnet.host.spawn_wp
    for d in range(1, len(spawns)):
        route = tr.trace_route(tnet, spawns[0], spawns[d])
        if route is not None and route["length"] >= 40:
            return 0, d
    raise AssertionError("no route from spawn point 0")


def _tiny_policy(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "tiny.pth")
    save_checkpoint_pth(path, CILRS(dropout=0.0, stage_sizes=(1, 1, 1, 1), speed_skip=True), 0, 0.0)
    return path


def _report_keys():
    return {"weather", "route_length_m", *jscore.compute_scores(j_init_metrics())}


def test_cli_drive_on_cpu(tmp_path):
    spawn, dest = _mini_route_pair(tt.make_mini_town())
    report, events = tmp_path / "report.json", tmp_path / "events.json"
    scores = drive_cli.main([
        "--map", "mini", "--device", "cpu", "--duration", "4", "--spawn", str(spawn),
        "--destination", str(dest), "--vehicles", "3", "--pedestrians", "1", "--no-hud",
        "--checkpoint", _tiny_policy(tmp_path), "--weather", "night",
        "--report-json", str(report), "--events-json", str(events)])
    with open(report) as f:
        written = json.load(f)
    assert set(written) == _report_keys()
    assert written["weather"] == "night" and written["route_length_m"] > 0
    assert written == json.loads(json.dumps({"weather": "night", **scores}))
    assert 0 < written["total_frames"] <= 80 and written["routes_attempted"] == 1.0
    with open(events) as f:
        assert isinstance(json.load(f), list)


def test_cli_benchmark_on_cpu(tmp_path):
    spawn, dest = _mini_route_pair(tt.make_mini_town())
    ckpt = _tiny_policy(tmp_path)
    argv = ["--map", "mini", "--device", "cpu", "--duration", "2", "--spawn", str(spawn),
            "--destination", str(dest), "--vehicles", "3", "--pedestrians", "1",
            "--weathers", "clear", "fog", "--checkpoint", ckpt,
            "--out", str(tmp_path / "RESULTS.md"), "--json-out", str(tmp_path / "bench.json"),
            "--events-dir", str(tmp_path / "events")]
    results = bench_cli.main(argv)
    assert list(results) == ["clear", "fog"]
    with open(tmp_path / "bench.json") as f:
        assert {w: set(s) for w, s in json.load(f).items()} == \
            {w: _report_keys() - {"weather"} for w in ("clear", "fog")}
    assert sorted(p.name for p in (tmp_path / "events").iterdir()) == \
        ["events_clear.json", "events_fog.json"]
    md = (tmp_path / "RESULTS.md").read_text().splitlines()
    args = argparse.Namespace(spawn=spawn, destination=dest, vehicles=3, pedestrians=1,
                              map="mini", duration=2.0, autopilot=False, checkpoint=ckpt)
    want = j_bench._format_markdown(results, args).splitlines()
    assert md[:-1] == want[:-1] and len(md) == 12
    assert md[-1].split(" Generated")[0] == want[-1].split(" Generated")[0]
    assert md[4].startswith("| Weather | Overall | Grade |")


HUD_CASES = {
    "float_frame_ok": dict(speed_kmh=23.4, command=0, steer=0.12, throttle=0.55, brake=0.0,
                           tl_state=0, obstacle_dist=40.0, dest_remaining_m=812.0, status=0,
                           safety_pct=97.5, distance_m=120.3, collisions=0, weather="clear"),
    "u8_frame_red_close": dict(speed_kmh=4.0, command=1, steer=-0.8, throttle=0.0, brake=0.9,
                               tl_state=2, obstacle_dist=5.0, dest_remaining_m=15.0, status=1,
                               safety_pct=61.0, distance_m=840.0, collisions=2, weather="night"),
    "str_status_warn": dict(speed_kmh=31.0, command=3, steer=0.4, throttle=0.2, brake=0.3,
                            tl_state=1, obstacle_dist=11.0, dest_remaining_m=0.0,
                            status="TELEPORT", safety_pct=0.0, distance_m=0.0, collisions=9,
                            weather="hardrain"),
}


@pytest.mark.parametrize("case", list(HUD_CASES))
def test_hud_compose_matches_jax(case):
    from cilrs_tpu.evaluation.hud import DashboardHUD as JHUD
    from cilrs_tpu_torch.evaluation.hud import HAS_CV2, DashboardHUD

    assert HAS_CV2
    frame = np.random.RandomState(len(case)).uniform(-0.1, 1.1, (88, 200, 3)).astype(np.float32)
    if case.startswith("u8"):
        frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    got = DashboardHUD().compose(frame, **HUD_CASES[case])
    want = JHUD().compose(frame, **HUD_CASES[case])
    assert got.shape == want.shape == (540, 960, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_cli_drive_chase_view_saves_a_video(tmp_path):
    """The chase view (``render_frame(CHASE_CAMERA, include_ego=True)``) and
    the HUD video writer: one composed 960x540 frame a chunk of 40 ticks."""
    import cv2

    spawn, dest = _mini_route_pair(tt.make_mini_town())
    video = tmp_path / "drive.mp4"
    drive_cli.main(["--map", "mini", "--device", "cpu", "--duration", "4", "--spawn", str(spawn),
                    "--destination", str(dest), "--vehicles", "3", "--pedestrians", "1",
                    "--no-hud", "--autopilot", "--view", "chase", "--save-video", str(video)])
    cap = cv2.VideoCapture(str(video))
    try:
        frames = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            frames.append(img)
    finally:
        cap.release()
    assert len(frames) == 2  # 4 s = 80 ticks = 2 chunks
    assert all(f.shape == (540, 960, 3) for f in frames) and frames[0].std() > 5
