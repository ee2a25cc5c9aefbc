"""Parity of the port's opt-in switches with the JAX package's: each set on
both sides with ``monkeypatch.setenv``, on the mini town.

 - the renderer's ``CILRS_TPU_LAMPS``, ``CILRS_TPU_NIGHT_LAMPS`` and
   ``CILRS_TPU_CROSSWALKS``, read when the module is imported: both raster
   modules are reloaded with the switches set, and reloaded again with them
   cleared at teardown, so that later tests in the same process see the
   defaults. A night and a clear frame, the ego 9 m before a light (its stop
   bar and crossing in view), braking NPCs ahead;
 - ``CILRS_TPU_STAGGER_LIGHTS`` (and its veto ``CILRS_TPU_GLOBAL_LIGHTS``),
   read when a network is built;
 - drive mode's ``CILRS_TPU_NO_REDHOLD`` and ``CILRS_TPU_NO_OFFROAD_ASSIST``:
   a short drive rollout as in tests/test_torch_drive.py, one env off the
   road;
 - ``CILRS_TPU_ALLOW_BIG_TABLE`` (a ``max_page_bytes`` that would make two
   pages makes one) and ``CILRS_TPU_CONTINUOUS_COLLECT`` (two pages, one
   session), as tests/test_torch_resident.py holds ``collect_resident``.

Tolerances are those of the files named, but for the switched frame: the
frame within tests/test_torch_render.py's bounds (at most 0.5% of the values
off by more than 0.05, mean difference under 1e-3), and the taillight and
paint pixels, which the switches add, on the same pixels in both packages
but for at most 1% of them. The crossing is a bf16 [pixels x 8] pass (the
port rounds after every bf16 operation, as torch does); the lamp bands are
edges of the box solve. Measured: 373 added pixels in each package (297 of
paint, 60 of brake lamps), none differing, and no frame value off by more
than 0.05. The switched tables' frames: at most 0.5% of the values off by
more than 0.05 (tests/test_torch_resident.py allows 1%; measured here 0.36%
to 0.43%).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu import config as jc  # noqa: E402
from cilrs_tpu.agent import driver as jd  # noqa: E402
from cilrs_tpu.agent import scenario as jsc  # noqa: E402
from cilrs_tpu.core.state import default_vehicle_params as j_params  # noqa: E402
from cilrs_tpu.core.state import make_world  # noqa: E402
from cilrs_tpu.data import resident as jres  # noqa: E402
from cilrs_tpu.maps import network as jn  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.maps import town as jt  # noqa: E402
from cilrs_tpu.render import raster as jr  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu_torch import config as tc  # noqa: E402
from cilrs_tpu_torch.agent import driver as td  # noqa: E402
from cilrs_tpu_torch.core.convert import (driver_state_from_arrays, pool_from_arrays,  # noqa: E402
                                          world_from_arrays)
from cilrs_tpu_torch.core.state import default_vehicle_params as t_params  # noqa: E402
from cilrs_tpu_torch.data import collect as tcol  # noqa: E402
from cilrs_tpu_torch.data import resident as tres  # noqa: E402
from cilrs_tpu_torch.maps import network as tn  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402
from cilrs_tpu_torch.render import raster as tr  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402

RENDER_SWITCHES = ("CILRS_TPU_LAMPS", "CILRS_TPU_NIGHT_LAMPS", "CILRS_TPU_CROSSWALKS")
RENDER_VETOES = ("CILRS_TPU_NO_LAMPS", "CILRS_TPU_NO_NIGHT_LAMPS")
HASH_BOUND, MAX_SHARE_BEYOND, MAX_MEAN_ERR = 0.05, 0.005, 1e-3
MAX_ADDED_PIXEL_MISMATCH = 0.01
# The drive rollout (tests/test_torch_drive.py's sizes and tolerances).
DRIVE_T, DRIVE_CAM = 30, dict(width=64, height=32)
ROLL_TOL = {"pos": 1e-4, "speed_kmh": 1e-4, "obstacle_dist": 1e-4}
FRAME_MAX_SHARE, FRAME_MAX_MEAN = 0.005, 0.05
# collect_resident (tests/test_torch_resident.py's sizes and tolerances):
# 160 frames under a byte limit of two pages of 80 logical rows.
E, V, P, T, SEED = 2, 4, 2, 20, 3
RES_CAM = dict(width=64, height=64)
D = 64 * 64 * 3
RES_FRAMES, RES_LIMIT = 160, 120 * D + 1
RES_TOL = {"speed": 1e-6, "controls": 1e-6, "speed_kmh": 1e-4, "pos": 1e-4, "yaw": 1e-4,
           "obstacle_dist": 1e-4}
RES_EXACT = ("command", "tl_state", "env", "tick")
# The tables' frames: the rain env's streak phase, which the JAX program at
# this width takes otherwise (tests/test_torch_resident.py), leaves 0.36-0.43%
# of the values off by more than 0.05 of the range.
FRAME_ATOL, RES_FRAME_MAX_SHARE, RES_FRAME_MAX_MEAN = 0.05 * 255, 0.005, 1e-3 * 255


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy); each
    test starts and ends with that cache empty."""
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


def tree_np(x):
    """A JAX state as nested dicts of (writable) numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "host"}
    return np.array(x)


def _jax_draws(keys, steps, p):
    """JAX's pedestrian uniforms of envs with keys ``keys``: [steps, E, p]."""
    def one(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (p,))
        return jax.lax.scan(body, key, None, length=steps)[1]
    return np.ascontiguousarray(np.asarray(jax.vmap(one)(keys)).transpose(1, 0, 2))


# --------------------------------------------------------------------------
# The renderer
# --------------------------------------------------------------------------


@pytest.fixture
def rasters(monkeypatch):
    """Both raster modules imported with the three switches set; both
    imported again with them cleared afterwards."""
    for k in RENDER_SWITCHES:
        monkeypatch.setenv(k, "1")
    for k in RENDER_VETOES:
        monkeypatch.delenv(k, raising=False)
    try:
        yield importlib.reload(jr), importlib.reload(tr)
    finally:
        monkeypatch.undo()
        importlib.reload(jr)
        importlib.reload(tr)
    assert not (tr._LAMPS or tr._NIGHT_LAMPS or tr._CROSSWALKS)


def _lamp_scene():
    """Three envs 9 m before a light (night, clear, night): NPCs ahead braking
    hard (0.8, in the lane to the left), braking lightly (0.3, to the right),
    reversing with the brake on (in the ego's lane, past the light), and one
    oncoming."""
    tnet = tt.make_mini_town()
    h = tnet.host
    worlds = []
    for e, weather in enumerate((3, 0, 3)):
        li = (3 * e) % len(h.light_xy)
        yaw = float(h.light_yaw[li])
        fwd = np.array([np.cos(yaw), np.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        xy = h.light_xy[li] - 9.0 * fwd
        w = make_world(num_vehicles=5, num_pedestrians=2, weather_idx=weather).replace(
            veh_pos=jnp.asarray(np.stack([xy, xy + fwd * 12 + left * 3.4, xy + fwd * 16 - left * 3.4,
                                          xy + fwd * 30, xy + fwd * 45 + left * 3.5]
                                         ).astype(np.float32)),
            veh_yaw=jnp.asarray(np.array([yaw, yaw, yaw + 0.1, yaw, yaw + 3.14], np.float32)),
            veh_alive=jnp.ones(5, bool),
            veh_control=jnp.asarray(np.array([[0, 0, 0], [0, 0, 0.8], [0, 0, 0.3], [0, 0, 0.9],
                                              [0, 0, 0.6]], np.float32)),
            veh_reverse=jnp.asarray(np.array([0, 0, 0, 1, 0], bool)),
            ped_pos=jnp.asarray(np.stack([xy + fwd * 9 + left * 5,
                                          xy - fwd * 5 - left * 5]).astype(np.float32)),
            ped_alive=jnp.ones(2, bool),
            time_s=jnp.asarray(np.float32(4.0 + 9 * e)))
        worlds.append(w)
    jworld = jax.tree.map(lambda *x: jnp.stack(x), *worlds)
    tworld = world_from_arrays([{f.name: np.asarray(getattr(w, f.name))
                                 for f in dataclasses.fields(w)} for w in worlds])
    return jt.make_mini_town(), tnet, jworld, tworld


def _render_both(jraster, traster, jnet, tnet, jworld, tworld):
    want = np.asarray(jax.jit(jax.vmap(
        lambda w: jraster.render_frame(jnet, w, jn.light_states(jnet, w.time_s))))(jworld))
    got = traster.render_frame(tnet, tworld, tn.light_states(tnet, tworld.time_s)).numpy()
    return want, got


def test_renderer_switches_match_jax(rasters):
    jraster, traster = rasters
    assert traster._LAMPS and traster._NIGHT_LAMPS and traster._CROSSWALKS
    jnet, tnet, jworld, tworld = _lamp_scene()
    want, got = _render_both(jraster, traster, jnet, tnet, jworld, tworld)
    assert got.shape == want.shape == (3, 88, 200, 3)
    diff = np.abs(got - want)
    assert (diff > HASH_BOUND).mean() <= MAX_SHARE_BEYOND, (diff > HASH_BOUND).mean()
    assert diff.mean() <= MAX_MEAN_ERR, diff.mean()

    # What the switches add: the frame against the defaults' in each package.
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jraster, traster):
            for flag in ("_LAMPS", "_NIGHT_LAMPS", "_CROSSWALKS"):
                mp.setattr(mod, flag, False)
        want0, got0 = _render_both(jraster, traster, jnet, tnet, jworld, tworld)
    added_j = np.abs(want - want0).max(-1) > HASH_BOUND
    added_t = np.abs(got - got0).max(-1) > HASH_BOUND
    assert added_j.sum() > 100 and added_t.sum() > 100  # lamps and paint in view
    assert (added_j != added_t).sum() <= MAX_ADDED_PIXEL_MISMATCH * added_j.sum()
    # The taillights: red-dominant added pixels on every env, the clear one
    # (env 1) by its braking NPC alone.
    red = (got[..., 0] > got[..., 1] + 0.2) & added_t
    assert red.reshape(3, -1).any(axis=1).all()


def test_renderer_switch_vetoes(monkeypatch):
    for k in RENDER_SWITCHES + RENDER_VETOES:
        monkeypatch.setenv(k, "1")
    try:
        mod = importlib.reload(tr)
        assert not mod._LAMPS and not mod._NIGHT_LAMPS and mod._CROSSWALKS
    finally:
        monkeypatch.undo()
        importlib.reload(tr)


# --------------------------------------------------------------------------
# Light stagger
# --------------------------------------------------------------------------


@pytest.mark.parametrize("veto", [False, True])
def test_light_stagger_matches_jax(monkeypatch, veto):
    monkeypatch.setenv("CILRS_TPU_STAGGER_LIGHTS", "1")
    if veto:
        monkeypatch.setenv("CILRS_TPU_GLOBAL_LIGHTS", "1")
    else:
        monkeypatch.delenv("CILRS_TPU_GLOBAL_LIGHTS", raising=False)
    jnet, tnet = jt.make_mini_town(), tt.make_mini_town()
    want, got = np.asarray(jnet.light_offset), tnet.light_offset.numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).any() != veto
    times = np.linspace(0.0, 60.0, 41, dtype=np.float32)
    jstates = np.stack([np.asarray(jn.light_states(jnet, jnp.float32(t))) for t in times])
    np.testing.assert_array_equal(tn.light_states(tnet, torch.from_numpy(times)).numpy(), jstates)


# --------------------------------------------------------------------------
# Drive mode: no red hold, no off-road assist
# --------------------------------------------------------------------------


def _stub_jax(img, speed_norm, cmd):
    m = jnp.tanh(jnp.mean(img, axis=(1, 2, 3)))
    return jnp.stack([0.1 * m, 0.5 + 0.1 * m, 0.3 + 0.2 * m], axis=-1)


def _stub_torch(img, speed_norm, cmd):
    m = torch.tanh(img.mean(dim=(1, 2, 3)))
    return torch.stack([0.1 * m, 0.5 + 0.1 * m, 0.3 + 0.2 * m], dim=-1)


def _drive_fleet(jnet):
    """Two envs as collect_session sets them up, in drive mode; env 1's ego
    starts 7 m to the side of its route, off the road."""
    rng = np.random.RandomState(4)
    pools, states = [], []
    for e in range(2):
        pool, meta = j_routing.chained_route_pool(jnet, rng, num_routes=3, min_dist=40.0,
                                                  max_dist=250.0, with_meta=True)
        w = jsc.spawn_world(jnet, 4, 2, rng, weather_idx=(0, 3)[e], seed=e)
        s = meta["start_wps"][0]
        xy, yaw = np.asarray(jnet.wp_xy)[s], float(np.asarray(jnet.wp_yaw)[s])
        if e == 1:
            xy = xy + 7.0 * np.array([-np.sin(yaw), np.cos(yaw)], np.float32)
        w = w.replace(veh_pos=w.veh_pos.at[0].set(jnp.asarray(xy)),
                      veh_yaw=w.veh_yaw.at[0].set(yaw), rng=jax.random.PRNGKey(e))
        pools.append(pool)
        states.append(jd.make_driver_state(w))
    return pools, states


def _drive_port(states, pools, draws):
    return td.fleet_rollout(
        driver_state_from_arrays([tree_np(s) for s in states]), DRIVE_T, tt.make_mini_town(),
        pool_from_arrays([tree_np(p) for p in pools]), tc.load_weather_table(), t_params(),
        torch.from_numpy(draws), mode="drive", cam=CameraSpec(**DRIVE_CAM), policy=_stub_torch)


def test_drive_switches_match_jax(monkeypatch):
    jnet = jt.make_mini_town()
    pools, states = _drive_fleet(jnet)
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)
    jstate, jpool = stack(states), stack(pools)
    draws = _jax_draws(jstate.world.rng, DRIVE_T, 2)
    _, default = _drive_port(states, pools, draws)
    monkeypatch.setenv("CILRS_TPU_NO_REDHOLD", "1")
    monkeypatch.setenv("CILRS_TPU_NO_OFFROAD_ASSIST", "1")
    wt, params = jc.load_weather_table(), j_params()
    final, want = jax.jit(jax.vmap(lambda s, p: jd.rollout(
        s, DRIVE_T, jnet, p, wt, params, _stub_jax, mode="drive", cam=JCam(**DRIVE_CAM),
        want_frames=True)))(jstate, jpool)
    got_final, got = _drive_port(states, pools, draws)
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
            np.testing.assert_allclose(g, w, atol=ROLL_TOL.get(k, 1e-5), rtol=0, err_msg=k)
    for name, w in tree_np(final.metrics).items():
        np.testing.assert_allclose(getattr(got_final.metrics, name).numpy(), w, atol=1e-4,
                                   rtol=1e-6, err_msg=name)
    # The off-road env drives on the policy's controls, not the assist's.
    assert not np.allclose(got["control"][1].numpy(), default["control"][1].numpy())


def test_no_redhold_clears_red_ahead(monkeypatch):
    """The red hold's input, with the ego 10 m before each light at red."""
    tnet = tt.make_mini_town()
    jnet = jt.make_mini_town()
    pools, states = _drive_fleet(jnet)
    base = tree_np(states[0])
    h = tnet.host
    fleet = []
    for li in range(len(h.light_xy)):
        s = {k: dict(v) if isinstance(v, dict) else v for k, v in base.items()}
        yaw = float(h.light_yaw[li])
        s["world"]["veh_pos"] = s["world"]["veh_pos"].copy()
        s["world"]["veh_pos"][0] = h.light_xy[li] - 10.0 * np.array([np.cos(yaw), np.sin(yaw)])
        s["world"]["veh_yaw"] = s["world"]["veh_yaw"].copy()
        s["world"]["veh_yaw"][0] = yaw
        fleet.append(s)
    tstate = driver_state_from_arrays(fleet)
    tpool = pool_from_arrays([tree_np(pools[0])] * len(fleet))
    reds = []
    for t in np.arange(0.0, 30.0, 1.0, dtype=np.float32):
        st = tstate.replace(world=tstate.world.replace(
            time_s=torch.full((len(fleet),), float(t))))
        reds.append(td.env_observe(st, tnet, tpool, CameraSpec(**DRIVE_CAM), mode="drive")["red_ahead"])
    assert torch.stack(reds).any()
    monkeypatch.setenv("CILRS_TPU_NO_REDHOLD", "1")
    for t in np.arange(0.0, 30.0, 1.0, dtype=np.float32):
        st = tstate.replace(world=tstate.world.replace(
            time_s=torch.full((len(fleet),), float(t))))
        assert not td.env_observe(st, tnet, tpool, CameraSpec(**DRIVE_CAM),
                                  mode="drive")["red_ahead"].any()


# --------------------------------------------------------------------------
# The resident table: one big page, one continuous session
# --------------------------------------------------------------------------


def _session_draws(session_seed: int, steps: int) -> torch.Tensor:
    keys = jnp.stack([jax.random.PRNGKey(session_seed * 997 + e) for e in range(E)])
    return torch.from_numpy(_jax_draws(keys, steps, P))


@pytest.mark.parametrize("switch,pages", [("CILRS_TPU_ALLOW_BIG_TABLE", 1),
                                          ("CILRS_TPU_CONTINUOUS_COLLECT", 2)])
def test_resident_switches_match_jax(monkeypatch, switch, pages):
    monkeypatch.setenv(switch, "1")
    kw = dict(num_envs=E, num_vehicles=V, num_pedestrians=P, weather_idx=None, seed=SEED,
              chunk_steps=T, verbose=False, max_page_bytes=RES_LIMIT)
    jtable, jlabels, jstats = jres.collect_resident(jt.make_mini_town(), RES_FRAMES,
                                                    cam=JCam(**RES_CAM), **kw)
    draws, served = {}, {}

    def jax_draws(generator, steps, num_envs, num_pedestrians, device):
        s = generator.initial_seed()  # the session's seed
        if s not in draws:
            draws[s] = _session_draws(s, 30 * T)
        k = served[s] = served.get(s, -1) + 1
        return draws[s][k * T:(k + 1) * T]

    monkeypatch.setattr(tcol, "draw_pedestrians", jax_draws)
    table, labels, stats = tres.collect_resident(tt.make_mini_town(), RES_FRAMES,
                                                 cam=CameraSpec(**RES_CAM), device="cpu", **kw)
    assert sorted(draws) == [SEED]  # one session
    assert len(table["images"]) == len(jtable["images"]) == pages
    assert table["page_rows"] == jtable["page_rows"] and stats["num_pages"] == jstats["num_pages"]
    pr = table["page_rows"]
    for p, (page, jpage) in enumerate(zip(table["images"], jtable["images"])):
        jpage = np.asarray(jpage).reshape(jpage.shape[0], -1)
        assert page.shape == jpage.shape
        rows = pr if p < pages - 1 else RES_FRAMES - p * pr
        d = np.abs(page[:rows].numpy().astype(int) - jpage[:rows].astype(int))
        assert (d > FRAME_ATOL).mean() <= RES_FRAME_MAX_SHARE and d.mean() <= RES_FRAME_MAX_MEAN, p
    for k in RES_EXACT:
        np.testing.assert_array_equal(labels[k], jlabels[k].astype(labels[k].dtype), err_msg=k)
    for k, tol in RES_TOL.items():
        np.testing.assert_allclose(labels[k], jlabels[k], atol=tol, rtol=0, err_msg=k)
    if pages == 2:  # the clock runs on across the page boundary
        assert labels["tick"][pr:].min() > 0
