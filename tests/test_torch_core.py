"""Parity of cilrs_tpu_torch.core (geometry, world state, dynamics, collisions)
with cilrs_tpu.core.

The same numpy inputs go through the JAX function (``jax.vmap`` over envs
where the port is batched) and through the port. Tolerances:
 - geometry and one physics step: atol 1e-5 plus rtol 1e-6, a few float32
   ulps of values up to a few hundred meters (XLA fuses multiply-adds, torch
   rounds each product);
 - the bicycle model over ten chained steps: atol 1e-5 m, 1e-6 rad and
   1e-6 m/s after the first step, ten times that after ten;
 - collisions and every boolean or integer: exact, on inputs kept away from
   the thresholds by more than the tolerance above.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.core import dynamics as jd  # noqa: E402
from cilrs_tpu.core import geometry as jg  # noqa: E402
from cilrs_tpu.core import state as js  # noqa: E402
from cilrs_tpu_torch.core import dynamics as td  # noqa: E402
from cilrs_tpu_torch.core import geometry as tg  # noqa: E402
from cilrs_tpu_torch.core import state as ts  # noqa: E402
from cilrs_tpu_torch.core.convert import world_from_arrays  # noqa: E402

POS_TOL = dict(atol=1e-5, rtol=1e-6)


def _np(x):
    return {f.name: np.array(getattr(x, f.name)) for f in dataclasses.fields(x)}


# Inputs of each geometry function, from a RandomState.
GEOMETRY = {
    "wrap_angle": lambda r: (r.uniform(-20, 20, 64),),
    "heading_vec": lambda r: (r.uniform(-4, 4, 64),),
    "rot2d": lambda r: (r.uniform(-4, 4, 64),),
    "world_to_body": lambda r: (r.uniform(-90, 90, (64, 2)), r.uniform(-90, 90, (64, 2)),
                                r.uniform(-4, 4, 64)),
    "body_to_world": lambda r: (r.uniform(-90, 90, (64, 2)), r.uniform(-90, 90, (64, 2)),
                                r.uniform(-4, 4, 64)),
    "cross2": lambda r: (r.uniform(-9, 9, (64, 2)), r.uniform(-9, 9, (64, 2))),
    "norm2": lambda r: (r.uniform(-90, 90, (64, 2)),),
    "segment_distance": lambda r: (r.uniform(-90, 90, (64, 2)), r.uniform(-90, 90, (64, 2)),
                                   r.uniform(-90, 90, (64, 2))),
}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_geometry_matches_jax(name):
    args = [a.astype(np.float32) for a in GEOMETRY[name](np.random.RandomState(1))]
    want = np.asarray(jax.jit(getattr(jg, name))(*args))
    got = getattr(tg, name)(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **POS_TOL)


def test_take_gathers_per_env():
    x = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    idx = torch.tensor([[4, 0], [1, 1]])
    assert torch.equal(tg.take(x, idx), torch.stack([x[0, [4, 0]], x[1, [1, 1]]]))
    assert torch.equal(tg.take(x[..., 0], torch.tensor([3, 2])), torch.tensor([9, 21]))


def _bicycle_inputs(n, seed):
    r = np.random.RandomState(seed)
    f = lambda *a: r.uniform(*a).astype(np.float32)
    speed = f(-4, 15, n)
    speed[:8] = 0.0  # stationary: the brake-hold branch
    throttle = f(0, 1, n)
    throttle[:4] = 0.0
    return dict(pos=f(-200, 200, (n, 2)), yaw=f(-3.1, 3.1, n), speed=speed,
                steer=f(-1, 1, n), throttle=throttle, brake=f(0, 1, n) * (r.rand(n) < 0.4),
                reverse=r.rand(n) < 0.2, friction=f(0.6, 1.0, n))


def test_bicycle_step_matches_jax():
    x = _bicycle_inputs(256, 2)
    jp, tp = js.default_vehicle_params(), ts.default_vehicle_params()
    jpos, jyaw, jspeed = x["pos"], x["yaw"], x["speed"]
    tpos, tyaw, tspeed = (torch.from_numpy(x[k]) for k in ("pos", "yaw", "speed"))
    step = jax.jit(lambda p, y, s, u: jd.bicycle_step(
        p, y, s, u["steer"], u["throttle"], u["brake"], u["reverse"], jp, u["friction"], 0.05))
    u = {k: torch.from_numpy(np.asarray(x[k])) for k in x}
    for k in range(10):
        jpos, jyaw, jspeed = step(jpos, jyaw, jspeed, x)
        tpos, tyaw, tspeed = td.bicycle_step(tpos, tyaw, tspeed, u["steer"], u["throttle"],
                                             u["brake"], u["reverse"], tp, u["friction"], 0.05)
        tol = 1 if k == 0 else 10
        np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-5 * tol, rtol=0)
        np.testing.assert_allclose(tyaw.numpy(), np.asarray(jyaw), atol=1e-6 * tol, rtol=0)
        np.testing.assert_allclose(tspeed.numpy(), np.asarray(jspeed), atol=1e-6 * tol, rtol=0)
    assert (tspeed.numpy() == 0).sum() == (np.asarray(jspeed) == 0).sum() > 0


def _worlds(E, V, P, seed):
    """E random JAX worlds (some actors dead) and their numpy arrays."""
    r = np.random.RandomState(seed)
    worlds = []
    for e in range(E):
        w = js.make_world(V, P, weather_idx=e % 5)
        alive = r.rand(V) < 0.8
        alive[0] = True
        w = w.replace(
            veh_pos=jnp.asarray(r.uniform(-30, 30, (V, 2)).astype(np.float32)),
            veh_yaw=jnp.asarray(r.uniform(-3, 3, V).astype(np.float32)),
            veh_speed=jnp.asarray(r.uniform(-2, 12, V).astype(np.float32)),
            veh_alive=jnp.asarray(alive),
            ped_pos=jnp.asarray(r.uniform(-30, 30, (P, 2)).astype(np.float32)),
            ped_yaw=jnp.asarray(r.uniform(-3, 3, P).astype(np.float32)),
            ped_speed=jnp.asarray(r.uniform(1, 2, P).astype(np.float32)),
            ped_alive=jnp.asarray(r.rand(P) < 0.8),
            time_s=jnp.asarray(np.float32(r.uniform(0, 100))),
        )
        worlds.append(w)
    return worlds, [_np(w) for w in worlds]


def test_make_world_matches_jax():
    j = js.make_world(5, 3, weather_idx=3)
    t = ts.make_world(2, 5, 3, weather_idx=3)
    for name, want in _np(j).items():
        if name == "rng":
            continue
        got = getattr(t, name)
        assert got.shape == (2,) + want.shape, name
        for e in range(2):
            np.testing.assert_array_equal(got[e].numpy(), want, err_msg=name)


def test_world_physics_step_matches_jax():
    E, V, P = 4, 6, 3
    worlds, arrays = _worlds(E, V, P, 3)
    r = np.random.RandomState(4)
    controls = r.uniform([-1.2, -0.1, -0.1], [1.2, 1.1, 1.1], (E, V, 3)).astype(np.float32)
    reverse = r.rand(E, V) < 0.2
    friction = np.array([1.0, 0.7, 0.9, 1.0], np.float32)
    jp = js.default_vehicle_params()
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *worlds)
    want = jax.jit(jax.vmap(lambda w, c, rv, f: jd.world_physics_step(w, c, rv, jp, f, 0.05)))(
        stacked, controls, reverse, friction)
    got = td.world_physics_step(world_from_arrays(arrays), torch.from_numpy(controls),
                                torch.from_numpy(reverse), ts.default_vehicle_params(),
                                torch.from_numpy(friction), 0.05)
    for name, w in _np(want).items():
        if name == "rng":
            continue
        g = getattr(got, name).numpy()
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(g, w, **POS_TOL, err_msg=name)


def test_collisions_match_jax():
    """Ego against NPCs and walkers at distances around the thresholds (two
    circles of radius 1.1 m per car, 0.4 m per walker)."""
    E, V, P = 64, 3, 2
    worlds, arrays = _worlds(E, V, P, 5)
    r = np.random.RandomState(6)
    for e, (w, a) in enumerate(zip(worlds, arrays)):
        # Pull actors near the ego so about half the envs collide.
        a["veh_pos"][1:] = a["veh_pos"][0] + r.uniform(-5, 5, (V - 1, 2)).astype(np.float32)
        a["ped_pos"] = (a["veh_pos"][0] + r.uniform(-3, 3, (P, 2))).astype(np.float32)
        worlds[e] = w.replace(veh_pos=jnp.asarray(a["veh_pos"]), ped_pos=jnp.asarray(a["ped_pos"]))
    jp = js.default_vehicle_params()
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *worlds)
    jv, jw = jax.vmap(lambda w: jd.detect_ego_collisions(w, jp))(stacked)
    tv, tw = td.detect_ego_collisions(world_from_arrays(arrays), ts.default_vehicle_params())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert 0 < tv.sum() < E and 0 < tw.sum() < E
