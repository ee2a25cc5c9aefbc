"""Parity of the port's closed loop in collect mode with the JAX package:
the weather table, perception, the NPC controller, the pedestrians' re-aim,
the autopilot teacher, scenario spawning, control smoothing, metrics, and a
50-tick ``fleet_rollout`` against ``jax.vmap(rollout)`` tick by tick.

JAX's PRNG and torch's generators draw different streams, so the pedestrians'
re-aim is held to JAX on JAX's own draws: its key chain (split once a tick,
``driver.py:318``) depends on the initial key only, so the test computes the
uniforms from it and passes them to the port.

Tolerances: booleans, integers (commands, light states, statuses, route
indices, teleport causes) exact; continuous values within a few float32 ulps
of their scale (XLA fuses multiply-adds, torch rounds each product):
 - perception distances, autopilot and NPC controls: atol 1e-5;
 - the 50-tick rollout: poses within 1e-4 m / 1e-5 rad, speeds within 1e-4
   km/h, controls within 1e-5. The u8 frames: at most 0.5% of the values
   differ by more than 1 (the renderer's tolerance, tests/test_torch_render.py:
   hash edges and layer edges), mean difference under 0.05.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu import config as jc  # noqa: E402
from cilrs_tpu.agent import autopilot as ja  # noqa: E402
from cilrs_tpu.agent import controller as jctl  # noqa: E402
from cilrs_tpu.agent import driver as jd  # noqa: E402
from cilrs_tpu.agent import npc as jnpc  # noqa: E402
from cilrs_tpu.agent import perception as jp  # noqa: E402
from cilrs_tpu.agent import scenario as jsc  # noqa: E402
from cilrs_tpu.core.state import default_vehicle_params as j_params  # noqa: E402
from cilrs_tpu.evaluation import metrics as jm  # noqa: E402
from cilrs_tpu.maps import network as jn  # noqa: E402
from cilrs_tpu.maps import routing as jr  # noqa: E402
from cilrs_tpu.maps import town as jt  # noqa: E402
from cilrs_tpu.ops import filters as jf  # noqa: E402
from cilrs_tpu_torch import config as tc  # noqa: E402
from cilrs_tpu_torch.agent import autopilot as ta  # noqa: E402
from cilrs_tpu_torch.agent import controller as tctl  # noqa: E402
from cilrs_tpu_torch.agent import driver as td  # noqa: E402
from cilrs_tpu_torch.agent import npc as tnpc  # noqa: E402
from cilrs_tpu_torch.agent import perception as tp  # noqa: E402
from cilrs_tpu_torch.agent import scenario as tsc  # noqa: E402
from cilrs_tpu_torch.core.convert import (driver_state_from_arrays, pool_from_arrays,  # noqa: E402
                                          world_from_arrays)
from cilrs_tpu_torch.core.state import default_vehicle_params as t_params  # noqa: E402
from cilrs_tpu_torch.evaluation import metrics as tm  # noqa: E402
from cilrs_tpu_torch.maps import network as tn  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402
from cilrs_tpu_torch.ops import filters as tf  # noqa: E402

CTRL_TOL = dict(atol=1e-5, rtol=0)
DIST_TOL = dict(atol=1e-5, rtol=1e-6)
FRAME_MAX_SHARE = 0.005
FRAME_MAX_MEAN = 0.05


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


@pytest.fixture(scope="module")
def nets():
    return jt.make_mini_town(), tt.make_mini_town()


@pytest.fixture(scope="module")
def worlds(nets):
    """32 envs from spawn_world (8 vehicles, 4 walkers): half on spawn
    points (a quarter of those moved off the road), half 2-20 m before a
    traffic light, with NPCs and walkers pulled into the ego's corridor, at
    random sim times."""
    jnet, _ = nets
    h = tt.make_mini_town().host
    r = np.random.RandomState(11)
    out = []
    for e in range(32):
        w = jsc.spawn_world(jnet, 8, 4, r, weather_idx=e % 5, seed=e)
        a = tree_np(w)
        if e % 2:
            li = r.randint(len(h.light_xy))
            yaw = float(h.light_yaw[li]) + r.uniform(-0.3, 0.3)
            a["veh_pos"][0] = h.light_xy[li] - r.uniform(2, 20) * np.array(
                [np.cos(yaw), np.sin(yaw)]) + r.uniform(-1.5, 1.5, 2)
            a["veh_yaw"][0] = yaw
        fwd = np.array([np.cos(a["veh_yaw"][0]), np.sin(a["veh_yaw"][0])])
        if e % 8 == 2:  # off the road, beside the lane
            a["veh_pos"][0] += np.array([-fwd[1], fwd[0]]) * r.uniform(5, 9)
        for v in range(1, 4):
            a["veh_pos"][v] = a["veh_pos"][0] + fwd * r.uniform(1, 25) + r.uniform(-2.5, 2.5, 2)
        a["ped_pos"][:2] = a["veh_pos"][0] + fwd * r.uniform(1, 25, (2, 1)) + r.uniform(-3, 3, (2, 2))
        a["veh_speed"][:] = r.uniform(0, 10, 8)
        a["time_s"] = np.float32(r.uniform(0, 200))
        out.append(w.replace(**{k: jnp.asarray(a[k]) for k in a if k != "rng"}))
    return stack(out), world_from_arrays([tree_np(w) for w in out])


def test_weather_table_matches_jax():
    want, got = jc.load_weather_table(), tc.load_weather_table()
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)
    for name in ("clear", "Hard-Rain", "clear_noon", "night", "fog", "rain"):
        assert tc.weather_index(name) == jc.weather_index(name)
    with pytest.raises(ValueError):
        tc.weather_index("snow")


PERCEPTION = {
    "check_traffic_light": (
        lambda net, w, ls: jp.check_traffic_light(net, ls, w.ego_pos, w.ego_yaw, return_index=True),
        lambda net, w, ls: tp.check_traffic_light(net, ls, w.ego_pos, w.ego_yaw)),
    "red_light_ahead": (
        lambda net, w, ls: jp.red_light_ahead(net, ls, w.ego_pos, w.ego_yaw),
        lambda net, w, ls: tp.red_light_ahead(net, ls, w.ego_pos, w.ego_yaw)),
    "obstacle_distance_teacher": (
        lambda net, w, ls: jp.get_obstacle_distance(w, horizons=(0.0,)),
        lambda net, w, ls: tp.get_obstacle_distance(w, horizons=(0.0,))),
    "obstacle_distance_predictive": (
        lambda net, w, ls: jp.get_obstacle_distance(w),
        lambda net, w, ls: tp.get_obstacle_distance(w)),
    "ego_off_road": (
        lambda net, w, ls: jp.ego_off_road(net, w.ego_pos),
        lambda net, w, ls: tp.ego_off_road(net, w.ego_pos)),
}


@pytest.mark.parametrize("name", list(PERCEPTION))
def test_perception_matches_jax(nets, worlds, name):
    jnet, tnet = nets
    jw, tw = worlds
    jfn, tfn = PERCEPTION[name]
    want = jax.jit(jax.vmap(lambda w: jfn(jnet, w, jn.light_states(jnet, w.time_s))))(jw)
    got = tfn(tnet, tw, tn.light_states(tnet, tw.time_s))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        else:
            np.testing.assert_allclose(g, w, **DIST_TOL)
    g = got[0].numpy()
    assert len(np.unique(g)) > 1  # the scene exercises both outcomes


def test_npc_controller_matches_jax(nets, worlds):
    jnet, tnet = nets
    jw, tw = worlds
    want_ctl, want_wp = jax.jit(jax.vmap(
        lambda w: jnpc.npc_controller(jnet, w, jn.light_states(jnet, w.time_s))))(jw)
    got_ctl, got_wp = tnpc.npc_controller(tnet, tw, tn.light_states(tnet, tw.time_s))
    np.testing.assert_array_equal(got_wp.numpy(), np.asarray(want_wp))
    np.testing.assert_allclose(got_ctl.numpy(), np.asarray(want_ctl), **CTRL_TOL)
    assert (np.asarray(want_ctl)[..., 2] == 0.8).any()  # some NPCs stop


def test_pedestrian_step_on_jax_draws(worlds):
    jw, tw = worlds
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(32, dtype=jnp.uint32) + 1000)
    want = np.asarray(jax.vmap(jnpc.pedestrian_step_targets)(jw, keys))
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (4,)))(keys))
    got = tnpc.pedestrian_step_targets(tw, torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # The same key draws the turn and the coin: every turn is the lowest
    # turn the coin allows (u < 0.02 -> turn in [-0.3, -0.288)).
    turned = got != tw.ped_yaw.numpy()
    assert (turned == (u < 0.02)).all()
    d = (got - tw.ped_yaw.numpy())[turned]
    assert ((d >= -0.3 - 1e-6) & (d < -0.287)).all()


@pytest.fixture(scope="module")
def pools(nets):
    jnet, _ = nets
    jr._graph_cache.clear()  # module fixtures run before the autouse one
    rng = np.random.RandomState(5)
    jpools = [jr.chained_route_pool(jnet, rng, num_routes=3) for _ in range(16)]
    return stack(jpools), pool_from_arrays([tree_np(p) for p in jpools])


def test_autopilot_matches_jax(pools):
    jpool, tpool = pools
    E = 16
    r = np.random.RandomState(8)
    rid = r.randint(0, 3, E)
    length = np.asarray(jpool.length)[np.arange(E), rid]
    idx = np.minimum(r.randint(0, 200, E), length - 1)
    idx[:4] = length[:4] - 1 - np.arange(4)  # near the end: the clamps
    xy = np.asarray(jpool.xy)[np.arange(E), rid, idx]
    yaw = np.asarray(jpool.yaw)[np.arange(E), rid, idx]
    pos = (xy + r.uniform(-1.5, 1.5, (E, 2))).astype(np.float32)
    yaw = (yaw + r.uniform(-0.4, 0.4, E)).astype(np.float32)
    speed = r.uniform(0, 40, E).astype(np.float32)
    obs = r.choice([999.0, 3.0, 9.0, 14.0, 18.0], E).astype(np.float32)
    tl = r.randint(0, 4, E).astype(np.int32)
    want = jax.jit(jax.vmap(lambda p, k, i, x, y, s, o, t: ja.autopilot_controls(
        p.get(k), i, x, y, s, o, t)))(jpool, rid, idx.astype(np.int32), pos, yaw, speed, obs, tl)
    route = tpool.get(torch.from_numpy(rid))
    got = ta.autopilot_controls(route, torch.from_numpy(idx), torch.from_numpy(pos),
                                torch.from_numpy(yaw), torch.from_numpy(speed),
                                torch.from_numpy(obs), torch.from_numpy(tl).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CTRL_TOL)


def test_spawn_world_identical(nets):
    jnet, tnet = nets
    rj, rt = np.random.RandomState(9), np.random.RandomState(9)
    for k, (V, P) in enumerate(((12, 6), (4, 2), (30, 1))):
        want, wi = jsc.spawn_world(jnet, V, P, rj, weather_idx=k, return_info=True)
        got, gi = tsc.spawn_world(tnet, V, P, rt, weather_idx=k, return_info=True)
        assert gi == wi
        for name, g in got.items():
            np.testing.assert_array_equal(g, np.asarray(getattr(want, name)), err_msg=name)
    assert rj.randint(1 << 30) == rt.randint(1 << 30)  # the same draws consumed


def test_smoothing_matches_jax():
    r = np.random.RandomState(1)
    steer, thr = r.uniform(-1, 1, (8, 4)).astype(np.float32), r.uniform(0, 1, (8, 4)).astype(np.float32)
    js_ = stack([jf.init_smoothing()] * 4)
    ts_ = tf.init_smoothing(4)
    for k in range(8):
        js_, jst, jth = jax.vmap(jf.smooth_controls)(js_, steer[k], thr[k])
        ts_, tst, tth = tf.smooth_controls(ts_, torch.from_numpy(steer[k]), torch.from_numpy(thr[k]))
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tth.numpy(), np.asarray(jth), atol=1e-6, rtol=0)
    assert tf.reset_smoothing(ts_).count.sum() == 0


def test_ctrl_state_matches_jax():
    now = np.array([0.0, 12.5, 99.95], np.float32)
    want = tree_np(jax.vmap(lambda t: jctl.reset_ctrl_state(jctl.init_ctrl_state(), t))(now))
    got = tctl.reset_ctrl_state(tctl.init_ctrl_state(3), torch.from_numpy(now))
    assert [tctl.ST_OK, tctl.ST_RECOVERY, tctl.OV_REVERSE, tctl.T_NONE] == \
        [jctl.ST_OK, jctl.ST_RECOVERY, jctl.OV_REVERSE, jctl.T_NONE]

    def check(g, w, name=""):
        if isinstance(w, dict):
            for k in w:
                check(getattr(g, k), w[k], f"{name}.{k}")
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype), err_msg=name)
    check(got, want)


def test_metrics_match_jax():
    r = np.random.RandomState(2)
    E = 6
    jmet, tmet = stack([jm.init_metrics()] * E), tm.init_metrics(E)
    for k in range(30):
        args = dict(
            speed_kmh=r.uniform(0, 40, E).astype(np.float32),
            steer=r.uniform(-1, 1, E).astype(np.float32), on_road=r.rand(E) < 0.9,
            now=np.full(E, 0.05 * k, np.float32), hit_vehicle=r.rand(E) < 0.3,
            hit_walker=r.rand(E) < 0.2, red_light_stop=r.rand(E) < 0.1,
            red_light_violation=r.rand(E) < 0.1, obstacle_brake=r.rand(E) < 0.1,
            route_completed=r.rand(E) < 0.05, route_attempted=r.rand(E) < 0.05,
            teleported=r.rand(E) < 0.05, recovered=r.rand(E) < 0.05)
        jmet = jax.vmap(lambda m, a: jm.update_metrics(m, dt=0.05, **a))(jmet, args)
        tmet = tm.update_metrics(tmet, dt=0.05, **{k: torch.from_numpy(v) for k, v in args.items()})
    for name, w in tree_np(jmet).items():
        np.testing.assert_allclose(getattr(tmet, name).numpy(), w, atol=1e-4, rtol=1e-6,
                                   err_msg=name)
    assert tmet.collisions.sum() > 0


def _fleet(jnet, scenario, E=3):
    """E envs as collect_session sets them up (chained pools, spawn, ego at
    the first route's start); 'collision' parks an NPC 3 m ahead of each
    ego, which drives the recovery machine."""
    rng = np.random.RandomState(3)
    pools, states = [], []
    for e in range(E):
        pool, meta = jr.chained_route_pool(jnet, rng, num_routes=3, min_dist=40.0,
                                           max_dist=250.0, with_meta=True)
        w = jsc.spawn_world(jnet, 4, 2, rng, weather_idx=(0, 1, 3)[e % 3], seed=e)
        s = meta["start_wps"][0]
        xy, yaw = np.asarray(jnet.wp_xy)[s], float(np.asarray(jnet.wp_yaw)[s])
        w = w.replace(veh_pos=w.veh_pos.at[0].set(jnp.asarray(xy)), veh_yaw=w.veh_yaw.at[0].set(yaw),
                      rng=jax.random.PRNGKey(e))
        if scenario == "collision":
            ahead = (xy + 3.0 * np.array([np.cos(yaw), np.sin(yaw)])).astype(np.float32)
            w = w.replace(veh_pos=w.veh_pos.at[1].set(jnp.asarray(ahead)),
                          veh_yaw=w.veh_yaw.at[1].set(yaw))
        pools.append(pool)
        states.append(jd.make_driver_state(w))
    return pools, states


def _jax_draws(keys, steps, P):
    """The uniforms of JAX's pedestrian re-aim, tick by tick: [T, E, P]."""
    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]
    return np.ascontiguousarray(np.asarray(jax.vmap(one)(keys)).transpose(1, 0, 2))


@pytest.mark.parametrize("scenario", ["traffic", "collision"])
def test_fleet_rollout_matches_jax(nets, scenario):
    jnet, tnet = nets
    T = 50
    pools, states = _fleet(jnet, scenario)
    jpool, jstate = stack(pools), stack(states)
    wt, params = jc.load_weather_table(), j_params()
    final, want = jax.jit(jax.vmap(lambda s, p: jd.rollout(
        s, T, jnet, p, wt, params, None, mode="collect", want_frames=True)))(jstate, jpool)
    draws = _jax_draws(jstate.world.rng, T, 2)

    got_final, got = td.fleet_rollout(
        driver_state_from_arrays([tree_np(s) for s in states]), T, tnet,
        pool_from_arrays([tree_np(p) for p in pools]), tc.load_weather_table(), t_params(),
        torch.from_numpy(draws))
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if k == "frame":
            d = np.abs(g.astype(int) - w.astype(int))
            assert (d > 1).mean() <= FRAME_MAX_SHARE and d.mean() <= FRAME_MAX_MEAN, k
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
        else:
            tol = {"pos": 1e-4, "speed_kmh": 1e-4, "obstacle_dist": 1e-4}.get(k, 1e-5)
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got_final.world.time_s.numpy(), np.asarray(final.world.time_s))
    np.testing.assert_allclose(got_final.world.ped_yaw.numpy(), np.asarray(final.world.ped_yaw),
                               atol=1e-6, rtol=0)
    for name, w in tree_np(final.metrics).items():
        np.testing.assert_allclose(getattr(got_final.metrics, name).numpy(), w, atol=1e-4,
                                   rtol=1e-6, err_msg=name)
    moved = np.asarray(final.metrics.total_distance)
    if scenario == "collision":
        assert np.asarray(want["status"] == jctl.ST_RECOVERY).any()
    else:
        assert (moved > 2.0).all()  # from a standstill, 2.5 s


def test_drive_mode_runs(nets):
    """Drive mode runs a policy through the safety cascade (its parity with
    the JAX package is tests/test_torch_drive.py); drive mode without a
    policy, and a mode the port does not know, raise."""
    jnet, tnet = nets
    pools, states = _fleet(jnet, "traffic", E=2)
    state = driver_state_from_arrays([tree_np(s) for s in states])
    pool = pool_from_arrays([tree_np(p) for p in pools])
    wt, params, draws = tc.load_weather_table(), t_params(), torch.rand(3, 2, 2)

    def policy(img, speed_norm, cmd):
        assert img.shape == (2, 88, 200, 3) and img.dtype == torch.float32
        return torch.stack([img.mean(dim=(1, 2, 3)) * 0.0, speed_norm * 0.0 + 0.5,
                            cmd.float() * 0.0], dim=-1)

    final, outs = td.fleet_rollout(state, 3, tnet, pool, wt, params, draws, mode="drive",
                                   policy=policy)
    assert outs["control"].shape == (2, 3, 3) and outs["frame"].shape == (2, 3, 88, 200, 3)
    np.testing.assert_allclose(final.world.time_s.numpy(), 0.15, atol=1e-6)
    with pytest.raises(ValueError, match="policy"):
        td.fleet_rollout(state, 3, tnet, pool, wt, params, draws, mode="drive")
    with pytest.raises(ValueError, match="mode"):
        td.env_observe(state, tnet, pool, mode="fly")
