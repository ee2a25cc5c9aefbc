"""Parity of cilrs_tpu_torch.maps (network builder, light phases, queries,
routing) with cilrs_tpu.maps.

 - The host builders are the same numpy: the networks of make_mini_town and
   make_town01, and the route pools of one seed, are equal array for array.
 - Light states and ages over a sweep of float32 sim times (accumulated tick
   by tick, as the simulator's clock is): exactly equal.
 - Queries and route following, held to ``jax.vmap`` of the JAX functions:
   indices and booleans exact; distances and the steer hint within 1e-5
   (float32 ulps of values up to a few hundred meters); texture samples
   within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.maps import network as jn  # noqa: E402
from cilrs_tpu.maps import queries as jq  # noqa: E402
from cilrs_tpu.maps import routing as jr  # noqa: E402
from cilrs_tpu.maps import town as jt  # noqa: E402
from cilrs_tpu_torch.core.convert import pool_from_arrays  # noqa: E402
from cilrs_tpu_torch.maps import network as tn  # noqa: E402
from cilrs_tpu_torch.maps import queries as tq  # noqa: E402
from cilrs_tpu_torch.maps import routing as tr  # noqa: E402
from cilrs_tpu_torch.maps import town as tt  # noqa: E402

DIST_TOL = dict(atol=1e-5, rtol=1e-6)
ROUTE_FIELDS = ("xy", "yaw", "option", "wp_index", "valid", "length", "kappa")


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy)
    (``cilrs_tpu/maps/routing.py:155-164``): a network freed by an earlier test
    can hand its id, and so its graph, to a new one. Each test here starts and
    ends with that cache empty."""
    jr._graph_cache.clear()
    yield
    jr._graph_cache.clear()


@pytest.fixture(scope="module")
def nets():
    return jt.make_mini_town(), tt.make_mini_town()


def _net_arrays(net):
    return {f.name: np.asarray(getattr(net, f.name)) for f in dataclasses.fields(net)
            if f.name != "host"}


@pytest.mark.parametrize("town", ["make_mini_town", "make_town01"])
def test_network_arrays_equal(town):
    want = getattr(jt, town)()
    got = getattr(tt, town)()
    for name, w in _net_arrays(want).items():
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
        if name in tn.HOST_FIELDS:
            np.testing.assert_array_equal(getattr(got.host, name), w, err_msg=name)
    # The same network from the JAX arrays.
    conv = tn.RoadNetwork.from_arrays(_net_arrays(want))
    for name in _net_arrays(want):
        assert torch.equal(getattr(conv, name), getattr(got, name)), name


def test_light_states_and_ages_exact(nets):
    jnet, tnet = nets
    clock = np.zeros(6000, np.float32)
    t = np.float32(0.0)
    for i in range(len(clock)):  # the simulator's clock: float32, += DT each tick
        clock[i] = t
        t = np.float32(t + np.float32(0.05))
    times = np.concatenate([clock, np.random.RandomState(0).uniform(0, 5000, 2000)
                            .astype(np.float32)])
    want = np.asarray(jax.vmap(lambda s: jn.light_states(jnet, s))(times))
    got = tn.light_states(tnet, torch.from_numpy(times)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}
    want_age = np.asarray(jax.vmap(lambda s: jn.light_state_ages(jnet, s))(times))
    got_age = tn.light_state_ages(tnet, torch.from_numpy(times)).numpy()
    np.testing.assert_array_equal(got_age, want_age)


def _points(net_np_xy, n, seed):
    r = np.random.RandomState(seed)
    base = net_np_xy[r.randint(len(net_np_xy), size=n)]
    return (base + r.uniform(-8, 8, (n, 2))).astype(np.float32)


@pytest.mark.parametrize("query", ["nearest_waypoint", "nearest_lane_waypoint",
                                   "is_on_road", "sample_texture"])
def test_queries_match_jax(nets, query):
    jnet, tnet = nets
    xy = _points(tnet.host.wp_xy, 300, 1)
    want = jax.jit(lambda p: getattr(jq, query)(jnet, p))(xy)
    got = getattr(tq, query)(tnet, torch.from_numpy(xy))
    if query in ("nearest_waypoint", "nearest_lane_waypoint"):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **DIST_TOL)
    elif query == "is_on_road":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < len(xy)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _pool_np(pool):
    return {f: np.asarray(getattr(pool, f)) for f in ROUTE_FIELDS}


@pytest.mark.parametrize("town,seed", [("make_mini_town", 3), ("make_town01", 0)])
def test_chained_route_pool_equal(town, seed):
    jnet, tnet = getattr(jt, town)(), getattr(tt, town)()
    want, want_meta = jr.chained_route_pool(jnet, np.random.RandomState(seed), num_routes=4,
                                            min_dist=60.0, max_dist=280.0, with_meta=True)
    got, got_meta = tr.chained_route_pool(tnet, np.random.RandomState(seed), num_routes=4,
                                          min_dist=60.0, max_dist=280.0, with_meta=True)
    assert got_meta == want_meta
    assert set(got) == set(ROUTE_FIELDS)
    for name, w in _pool_np(want).items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_trace_and_random_route_equal(nets):
    jnet, tnet = nets
    rj, rt = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(4):
        (wr, ws, we), (gr, gs, ge) = jr.random_route(jnet, rj), tr.random_route(tnet, rt)
        assert (gs, ge) == (ws, we)
        for name in ROUTE_FIELDS:
            np.testing.assert_array_equal(gr[name], np.asarray(getattr(wr, name)), err_msg=name)
    assert tr.trace_route(tnet, 0, 0) is None  # a path shorter than 4 waypoints


def test_python_dijkstra_matches_native(nets):
    """The heapq fallback (no C++ compiler) finds the native engine's paths."""
    _, tnet = nets
    g = tr.host_graph(tnet)
    assert g._nat_graph is not None
    pairs = np.random.RandomState(2).randint(0, tnet.num_waypoints, (20, 2))
    native = [g.dijkstra(int(a), int(b)) for a, b in pairs]
    nat, g._nat_graph = g._nat_graph, None
    try:
        fallback = [g.dijkstra(int(a), int(b)) for a, b in pairs]
    finally:
        g._nat_graph = nat
    assert fallback == native
    assert sum(len(p) > 0 for p in native) > 10


@pytest.fixture(scope="module")
def pools(nets):
    jnet, tnet = nets
    jr._graph_cache.clear()  # module fixtures run before the autouse one
    rng = np.random.RandomState(5)
    jpools = [jr.chained_route_pool(jnet, rng, num_routes=3) for _ in range(3)]
    return jpools, pool_from_arrays([_pool_np(p) for p in jpools])


def _following_inputs(jpools, n_per_env=40, seed=4):
    """Route indices near the start, middle and end of each env's route 0..2
    (the clamps at length - 1 matter there) and positions near the route."""
    r = np.random.RandomState(seed)
    E = len(jpools)
    rid = r.randint(0, 3, (n_per_env, E))
    idx = np.zeros((n_per_env, E), np.int64)
    pos = np.zeros((n_per_env, E, 2), np.float32)
    yaw = r.uniform(-3.1, 3.1, (n_per_env, E)).astype(np.float32)
    for k in range(n_per_env):
        for e in range(E):
            length = int(jpools[e].length[rid[k, e]])
            idx[k, e] = [0, 1, length // 2, length - 3, length - 1, length + 7][k % 6]
            i = min(idx[k, e], length - 1)
            pos[k, e] = np.asarray(jpools[e].xy[rid[k, e], i]) + r.uniform(-6, 6, 2)
    return rid, idx, pos, yaw


@pytest.mark.parametrize("fn", ["localize", "get_command", "steer_hint", "is_complete"])
def test_route_following_near_route_end(pools, fn):
    jpools, tpool = pools
    rid, idx, pos, yaw = _following_inputs(jpools)

    def one(p, r, i, x, y):
        route = p.get(r)
        args = {"localize": (route, i, x), "get_command": (route, i),
                "steer_hint": (route, i, x, y), "is_complete": (route, x)}[fn]
        return getattr(jr, fn)(*args)

    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jpools)
    jfn = jax.jit(jax.vmap(one))
    for k in range(len(rid)):
        want = np.asarray(jfn(stacked, jnp.asarray(rid[k]), jnp.asarray(idx[k], jnp.int32),
                              pos[k], yaw[k]))
        route = tpool.get(torch.from_numpy(rid[k]))
        i, x, y = torch.from_numpy(idx[k]), torch.from_numpy(pos[k]), torch.from_numpy(yaw[k])
        args = {"localize": (route, i, x), "get_command": (route, i),
                "steer_hint": (route, i, x, y), "is_complete": (route, x)}[fn]
        got = getattr(tr, fn)(*args).numpy()
        if fn == "steer_hint":
            np.testing.assert_allclose(got, want, **DIST_TOL)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype))
