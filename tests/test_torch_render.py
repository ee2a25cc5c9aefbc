"""Parity of cilrs_tpu_torch.render (camera, weather shading, rasterizer, motion
blur) with cilrs_tpu.render, on the mini town and Town01, all five weathers,
with NPCs, walkers and traffic lights in view.

Tolerances, from what the renderer's numerics allow:
 - camera rays and positions, weather shading, motion blur: atol 1e-6 on
   values of order 1 (float32 ulps; XLA fuses multiply-adds);
 - which layer wins each pixel (sky, grass, sidewalk, road, marking, box,
   walker, pole, light head): the same on at least 99.5% of the pixels. The
   ground classes come from a bf16 [pixels x 72] pass and the box depths from
   a bf16 solve, as in the JAX function, so a pixel on an edge may fall on
   either side;
 - the frame: at most 0.5% of the values differ by more than 0.05, and the
   mean difference is under 1e-3. 0.05 is the bound of the hash noise: the
   ground grain adds at most 0.025 (``raster.py:402-407``), so one hash value
   against any other differs by at most 0.05 before light and fog dim it.
   The grain and rain hashes themselves agree bit for bit
   (tests/test_torch_sinf.py), so a grain cell differs only where the ground
   point itself does; edge pixels are the rest of the 0.5%. Measured: no
   value off by more than 1e-3 in either town.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.core.state import make_world  # noqa: E402
from cilrs_tpu.maps import network as jn  # noqa: E402
from cilrs_tpu.maps import town as jt  # noqa: E402
from cilrs_tpu.render import camera as jcam  # noqa: E402
from cilrs_tpu.render import raster as jr  # noqa: E402
from cilrs_tpu.render import weather as jw  # noqa: E402
from cilrs_tpu_torch.core.convert import world_from_arrays  # noqa: E402
from cilrs_tpu_torch.maps import network as tn  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402
from cilrs_tpu_torch.render import camera as tcam  # noqa: E402
from cilrs_tpu_torch.render import raster as tr  # noqa: E402
from cilrs_tpu_torch.render import weather as tw  # noqa: E402

SMALL_TOL = dict(atol=1e-6, rtol=0)
MIN_LAYER_AGREEMENT = 0.995
HASH_BOUND = 0.05
MAX_SHARE_BEYOND = 0.005
MAX_MEAN_ERR = 1e-3
INF = jr.INF


@pytest.fixture(scope="module", params=["make_mini_town", "make_town01"])
def scene(request):
    """Five envs, one per weather: ego on a spawn point or 15 m before a
    traffic light, an NPC ahead, one oncoming, one behind, two walkers."""
    jnet, tnet = getattr(jt, request.param)(), getattr(tt, request.param)()
    h = tnet.host
    r = np.random.RandomState(0)
    worlds = []
    for e in range(5):
        if e % 2 == 0:
            wp = int(h.spawn_wp[r.randint(len(h.spawn_wp))])
            xy, yaw = h.wp_xy[wp], float(h.wp_yaw[wp])
        else:
            li = r.randint(len(h.light_xy))
            yaw = float(h.light_yaw[li])
            xy = h.light_xy[li] - 15.0 * np.array([np.cos(yaw), np.sin(yaw)])
        fwd = np.array([np.cos(yaw), np.sin(yaw)])
        left = np.array([-fwd[1], fwd[0]])
        w = make_world(num_vehicles=4, num_pedestrians=2, weather_idx=e).replace(
            veh_pos=jnp.asarray(np.stack([xy, xy + fwd * 18, xy + fwd * 40 + left * 3.5,
                                          xy - fwd * 15]).astype(np.float32)),
            veh_yaw=jnp.asarray(np.array([yaw, yaw + 0.3, yaw + 3.14, yaw], np.float32)),
            veh_alive=jnp.ones(4, bool),
            veh_speed=jnp.asarray(np.array([6.0 + e, 3, 0, 0], np.float32)),
            ped_pos=jnp.asarray(np.stack([xy + fwd * 10 + left * 4,
                                          xy + fwd * 25 - left * 5]).astype(np.float32)),
            ped_alive=jnp.ones(2, bool),
            time_s=jnp.asarray(np.float32(3.7 + 11 * e)))
        worlds.append(w)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *worlds)
    tworld = world_from_arrays([{f.name: np.asarray(getattr(w, f.name))
                                 for f in dataclasses.fields(w)} for w in worlds])
    return jnet, tnet, stacked, tworld


def _classify(t_layers, road, marking, sidewalk):
    """Layer ids from the depths [E, 5, N] (ground, boxes, walkers, poles,
    heads) and the ground masks: 0 sky, 1 grass, 2 sidewalk, 3 road, 4
    marking, 5 box, 6 walker, 7 pole, 8 head. Earlier layers win depth ties,
    as the compose loop's strict compare does."""
    first = np.argmin(t_layers, axis=1)
    ground = np.where(marking > 0, 4, np.where(road > 0, 3, np.where(sidewalk > 0, 2, 1)))
    layer = np.where(first == 0, ground, first + 4)
    return np.where(np.min(t_layers, axis=1) >= INF, 0, layer)


def _jax_layers(net, w, ls):
    spec = jr.CAMERA
    o = jcam.camera_position(spec, w.ego_pos, w.ego_yaw)
    rays = jcam.ray_directions(spec, w.ego_yaw).reshape(-1, 3)
    dz = rays[:, 2]
    t_g = jnp.where(dz < -1e-4, o[2] / jnp.maximum(-dz, 1e-6), INF)
    t_g = jnp.where(t_g < spec.far, t_g, INF)
    masks = jr._ground_masks(net, w.ego_pos, o[:2] + rays[:, :2] * t_g[:, None])
    o_rel = jnp.array([0.0, 0.0, 1.0], jnp.float32) * o[2]
    _, nb = jax.lax.top_k(-jnp.sum((net.bldg_xy - w.ego_pos) ** 2, -1), jr.NUM_NEAR_BUILDINGS)
    V1 = w.veh_pos.shape[0] - 1
    t_box, _, _ = jr._ray_obb(
        o_rel, rays, jnp.concatenate([w.veh_pos[1:], net.bldg_xy[nb]]) - o[:2],
        jnp.concatenate([w.veh_yaw[1:], net.bldg_yaw[nb]]),
        jnp.concatenate([jnp.full(V1, 4.7 / 2, jnp.float32), net.bldg_half[nb, 0]]),
        jnp.concatenate([jnp.full(V1, 2.0 / 2, jnp.float32), net.bldg_half[nb, 1]]),
        jnp.concatenate([jnp.full(V1, jr.VEH_HEIGHT, jnp.float32), net.bldg_h[nb]]))
    alive = jnp.concatenate([w.veh_alive[1:], jnp.ones(len(nb), bool)])
    t16 = jnp.min(jnp.where(alive[None], t_box, INF).astype(jnp.bfloat16), axis=1)
    t_v = jnp.where(t16 < jnp.asarray(INF, jnp.bfloat16), t16.astype(jnp.float32), INF)
    t_p = jnp.min(jnp.where(w.ped_alive[None], jr._ray_cylinder(
        o_rel, rays, w.ped_pos - o[:2], jr.PED_RADIUS, jr.PED_HEIGHT), INF), axis=1)
    _, near = jax.lax.top_k(-jnp.sum((net.light_xy - w.ego_pos) ** 2, -1), jr.NUM_NEAR_LIGHTS)
    lyaw = net.light_yaw[near]
    pole = net.light_xy[near] + jnp.stack([jnp.sin(lyaw), -jnp.cos(lyaw)], -1) * 2.4 - o[:2]
    t_pole = jnp.min(jr._ray_cylinder(o_rel, rays, pole, 0.12, jr.LIGHT_POLE_H), axis=1)
    head = jnp.concatenate([pole, jnp.full((len(near), 1), jr.LIGHT_POLE_H)], -1)
    t_h = jnp.min(jr._ray_sphere(o_rel, rays, head, jr.LIGHT_HEAD_R), axis=1)
    return jnp.stack([t_g, t_v, t_p, t_pole, t_h]), masks


def _torch_layers(net, w, ls):
    spec = tr.CAMERA
    E = w.num_envs
    o = tcam.camera_position(spec, w.ego_pos, w.ego_yaw)
    rays = tcam.ray_directions(spec, w.ego_yaw).reshape(E, -1, 3)
    dz = rays[..., 2]
    t_g = torch.where(dz < -1e-4, o[:, 2:3] / torch.clamp(-dz, min=1e-6), INF)
    t_g = torch.where(t_g < spec.far, t_g, INF)
    masks = tr._ground_masks(net, w.ego_pos, o[:, None, :2] + rays[..., :2] * t_g[..., None])
    oz = float(o[0, 2])
    nb = tr.nearest_k(torch.sum((net.bldg_xy - w.ego_pos[:, None]) ** 2, -1),
                      tr.NUM_NEAR_BUILDINGS)
    V1 = w.num_vehicles - 1
    full = lambda v: torch.full((E, V1), v, dtype=torch.float32)
    t_box, _ = tr._ray_obb(
        oz, rays, torch.cat([w.veh_pos[:, 1:], net.bldg_xy[nb]], 1) - o[:, None, :2],
        torch.cat([w.veh_yaw[:, 1:], net.bldg_yaw[nb]], 1),
        torch.cat([full(4.7 / 2), net.bldg_half[nb, 0]], 1),
        torch.cat([full(2.0 / 2), net.bldg_half[nb, 1]], 1),
        torch.cat([full(tr.VEH_HEIGHT), net.bldg_h[nb]], 1))
    alive = torch.cat([w.veh_alive[:, 1:], torch.ones_like(nb, dtype=torch.bool)], 1)
    t16 = torch.where(alive[:, None], t_box, INF).to(torch.bfloat16).amin(-1)
    t_v = torch.where(t16 < tr._BF_INF, t16.float(), INF)
    t_p = torch.where(w.ped_alive[:, None], tr._ray_cylinder(
        oz, rays, w.ped_pos - o[:, None, :2], tr.PED_RADIUS, tr.PED_HEIGHT), INF).amin(-1)
    near = tr.nearest_k(torch.sum((net.light_xy - w.ego_pos[:, None]) ** 2, -1),
                        tr.NUM_NEAR_LIGHTS)
    lyaw = net.light_yaw[near]
    pole = net.light_xy[near] + torch.stack([torch.sin(lyaw), -torch.cos(lyaw)], -1) * 2.4 \
        - o[:, None, :2]
    t_pole = tr._ray_cylinder(oz, rays, pole, 0.12, tr.LIGHT_POLE_H).amin(-1)
    head = torch.cat([pole, torch.full(near.shape + (1,), tr.LIGHT_POLE_H)], -1)
    t_h = tr._ray_sphere(oz, rays, head, tr.LIGHT_HEAD_R).amin(-1)
    return torch.stack([t_g, t_v, t_p, t_pole, t_h], 1), masks


def test_render_frame_matches_jax(scene):
    jnet, tnet, jworld, tworld = scene
    want = np.asarray(jax.jit(jax.vmap(
        lambda w: jr.render_frame(jnet, w, jn.light_states(jnet, w.time_s))))(jworld))
    got = tr.render_frame(tnet, tworld, tn.light_states(tnet, tworld.time_s)).numpy()
    assert got.shape == want.shape == (5, 88, 200, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    diff = np.abs(got - want)
    assert (diff > HASH_BOUND).mean() <= MAX_SHARE_BEYOND, (diff > HASH_BOUND).mean()
    assert diff.mean() <= MAX_MEAN_ERR, diff.mean()

    jt_layers, jmasks = jax.jit(jax.vmap(
        lambda w: _jax_layers(jnet, w, jn.light_states(jnet, w.time_s))))(jworld)
    tt_layers, tmasks = _torch_layers(tnet, tworld, tn.light_states(tnet, tworld.time_s))
    want_layers = _classify(np.asarray(jt_layers), *(np.asarray(m) for m in jmasks))
    got_layers = _classify(tt_layers.numpy(), *(m.numpy() for m in tmasks))
    assert (got_layers == want_layers).mean() >= MIN_LAYER_AGREEMENT
    # The scene shows every layer: sky, ground classes, boxes, walkers,
    # poles and light heads.
    assert set(np.unique(want_layers)) >= {0, 1, 2, 3, 4, 5, 6, 7}


def test_chase_frame_with_the_ego_matches_jax(scene):
    """The spectator view of ``cli.drive --view chase``: the chase camera
    with the ego's own box drawn, held to the front camera's bounds."""
    jnet, tnet, jworld, tworld = scene
    want = np.asarray(jax.jit(jax.vmap(lambda w: jr.render_frame(
        jnet, w, jn.light_states(jnet, w.time_s), jcam.CHASE_CAMERA, include_ego=True)))(jworld))
    got = tr.render_frame(tnet, tworld, tn.light_states(tnet, tworld.time_s), tcam.CHASE_CAMERA,
                          include_ego=True).numpy()
    assert got.shape == want.shape == (5, 180, 320, 3)
    diff = np.abs(got - want)
    assert (diff > HASH_BOUND).mean() <= MAX_SHARE_BEYOND and diff.mean() <= MAX_MEAN_ERR
    # The ego's box is in view: drawn without it, the frame changes.
    without = tr.render_frame(tnet, tworld, tn.light_states(tnet, tworld.time_s),
                              tcam.CHASE_CAMERA).numpy()
    assert np.abs(without - got).max() > 0.1


def test_render_night_darker_than_clear(scene):
    _, tnet, _, tworld = scene
    img = tr.render_frame(tnet, tworld, tn.light_states(tnet, tworld.time_s))
    assert img[0].mean() > img[3].mean() + 0.05  # clear vs night


def test_camera_matches_jax():
    yaw = np.random.RandomState(0).uniform(-3.1, 3.1, 4).astype(np.float32)
    pos = np.random.RandomState(1).uniform(-100, 100, (4, 2)).astype(np.float32)
    for spec in (jcam.CameraSpec(), jcam.CHASE_CAMERA):
        tspec = tcam.CameraSpec(**dataclasses.asdict(spec))
        want = np.asarray(jax.jit(jax.vmap(lambda y: jcam.ray_directions(spec, y)))(yaw))
        got = tcam.ray_directions(tspec, torch.from_numpy(yaw)).numpy()
        np.testing.assert_allclose(got, want, **SMALL_TOL)
        want = np.asarray(jax.jit(jax.vmap(lambda p, y: jcam.camera_position(spec, p, y)))(pos, yaw))
        got = tcam.camera_position(tspec, torch.from_numpy(pos), torch.from_numpy(yaw)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_nearest_k_breaks_ties_like_top_k():
    d2 = np.array([[4.0, 1.0, 1.0, 9.0, 1.0, 0.0, 4.0, 4.0]], np.float32)
    for k in (1, 3, 4, 6):
        _, want = jax.lax.top_k(-d2, k)
        got = tr.nearest_k(torch.from_numpy(d2), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _weather_inputs():
    r = np.random.RandomState(3)
    E, H, W = 5, 88, 200
    widx = np.arange(E)
    uu, vv = (a.numpy() for a in tcam.pixel_coords(tcam.CameraSpec(), "cpu"))
    return dict(widx=widx, uu=uu, vv=vv, elev=r.uniform(-0.2, 1.2, (E, 64)).astype(np.float32),
                color=r.uniform(0, 1, (E, H, W, 3)).astype(np.float32),
                dist=r.uniform(0, 150, (E, H, W)).astype(np.float32),
                time=np.array([0.0, 3.7, 47.7, 123.45, 1000.05], np.float32),
                road=np.array([0.23, 0.23, 0.24], np.float32))


WEATHER_FNS = {
    "sky_color": lambda m, x: m.sky_color(x["widx"], x["elev"]),
    "apply_atmosphere": lambda m, x: m.apply_atmosphere(x["widx"], x["color"], x["dist"]),
    "wet_darken": lambda m, x: m.wet_darken(x["widx"], x["road"]),
    "headlight": lambda m, x: m.headlight(x["widx"], x["uu"], x["vv"], x["dist"], x["color"]),
    "rain_streaks": lambda m, x: m.rain_streaks(x["widx"], x["uu"], x["vv"], x["time"],
                                                x["color"]),
}


@pytest.mark.parametrize("name", list(WEATHER_FNS))
def test_weather_shading_matches_jax(name):
    fn = WEATHER_FNS[name]
    x = _weather_inputs()
    shared = {"uu", "vv", "road"}
    # Under jit, as the JAX package runs it (XLA fuses multiply-adds only
    # there), with every input an argument: the renderer's pixel coordinates
    # are computed in the program, and a constant closure would be folded
    # at compile time with other roundings.
    want = np.asarray(jax.jit(lambda sh, per_env: jax.vmap(lambda **kw: fn(jw, {**kw, **sh}))(
        **per_env))({k: x[k] for k in shared}, {k: v for k, v in x.items() if k not in shared}))
    got = fn(tw, {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}).numpy()
    diff = np.abs(got - want)
    if name == "rain_streaks":
        # A streak starts where a hash crosses a threshold: a pixel on that
        # edge may be in or out (the streak overlay moves it by up to 0.35).
        assert (diff > 1e-6).mean() <= MAX_SHARE_BEYOND and diff.mean() <= MAX_MEAN_ERR
    else:
        np.testing.assert_allclose(got, want, **SMALL_TOL)


def test_motion_blur_matches_jax():
    x = np.random.RandomState(4).uniform(0, 1, (4, 88, 200, 3)).astype(np.float32)
    speed = np.array([0.0, 12.0, 36.0, 50.0], np.float32)
    want = np.asarray(jax.jit(jax.vmap(jr.motion_blur))(x, speed))
    got = tr.motion_blur(torch.from_numpy(x), torch.from_numpy(speed)).numpy()
    np.testing.assert_allclose(got, want, **SMALL_TOL)
