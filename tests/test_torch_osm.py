"""Parity of cilrs_tpu_torch.maps.{osm,landmarks} with the JAX package's OSM
import, on the inline campus of tests/test_osm.py (two residential streets
crossing, a service spur, and a footway that must be filtered out).

Both are host numpy and ``xml.etree`` over the same network builder, so:
parsed nodes and ways, the GraphSpec, the OpenDRIVE file, the landmark snaps
and the route suggestions are equal; the network's arrays are held within
1e-5 (integers exact); ``cli.common.build_map("osm:<path>")`` builds the same
network.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cilrs_tpu.maps import landmarks as jlm  # noqa: E402
from cilrs_tpu.maps import osm as josm  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu_torch.cli.common import build_map  # noqa: E402
from cilrs_tpu_torch.maps import landmarks as tlm  # noqa: E402
from cilrs_tpu_torch.maps import osm as tosm  # noqa: E402
from cilrs_tpu_torch.maps import routing as t_routing  # noqa: E402

# tests/test_osm.py:16-41.
OSM_XML = """<?xml version='1.0' encoding='UTF-8'?>
<osm version='0.6'>
  <node id='1' lat='10.0400' lon='76.3300'/>
  <node id='2' lat='10.0400' lon='76.3340'/>
  <node id='3' lat='10.0400' lon='76.3380'/>
  <node id='4' lat='10.0380' lon='76.3340'/>
  <node id='5' lat='10.0420' lon='76.3340'/>
  <node id='6' lat='10.0420' lon='76.3380'/>
  <node id='7' lat='10.0400' lon='76.3341'/>
  <way id='100'>
    <nd ref='1'/><nd ref='2'/><nd ref='3'/>
    <tag k='highway' v='residential'/>
  </way>
  <way id='101'>
    <nd ref='4'/><nd ref='2'/><nd ref='5'/>
    <tag k='highway' v='tertiary'/>
  </way>
  <way id='102'>
    <nd ref='5'/><nd ref='6'/>
    <tag k='highway' v='service'/>
  </way>
  <way id='103'>
    <nd ref='2'/><nd ref='7'/>
    <tag k='highway' v='footway'/>
  </way>
</osm>
"""
NET_TOL = 1e-5
LANDMARKS = {"Main Gate": (10.0400, 76.3302), "Library": (10.0418, 76.3340),
             "Far Corner": (10.0400, 76.3378)}
ORIGIN = (10.0400, 76.3340)


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


@pytest.fixture(scope="module")
def osm_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("osm") / "campus.osm"
    p.write_text(OSM_XML)
    return str(p)


@pytest.fixture(scope="module")
def nets(osm_file):
    return josm.load_osm_network(osm_file, tex_scale=1.0), tosm.load_osm_network(osm_file, tex_scale=1.0)


@pytest.mark.parametrize("bounds", [None, (10.039, 76.329, 10.041, 76.335)])
def test_parse_osm_matches_jax(osm_file, bounds):
    got, want = tosm.parse_osm(osm_file, bounds), josm.parse_osm(osm_file, bounds)
    assert got == want
    assert (len(got[0]), len(got[1])) == ((7, 3) if bounds is None else (3, 1))


def test_projection_matches_jax():
    for args in ((10.041, 76.331, 10.040, 76.330), (-33.9, 151.2, -33.85, 151.25)):
        assert tosm.lat_lon_to_xy(*args) == josm.lat_lon_to_xy(*args)


def test_graph_spec_matches_jax(osm_file):
    got, want = tosm.osm_to_graph(osm_file), josm.osm_to_graph(osm_file)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    assert got.edges == want.edges and got.lanes_per_dir == want.lanes_per_dir
    assert len(got.edges) >= 4


def test_network_matches_jax(nets):
    want, got = nets
    fields = [f.name for f in dataclasses.fields(got) if f.name != "host"]
    for name in fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=NET_TOL, rtol=0, err_msg=name)
    assert got.num_waypoints > 50 and got.num_spawn_points > 3 and got.num_lights >= 3
    # Routes are traceable on the imported map, as on the JAX one.
    h = got.host
    found = [t_routing.trace_route(got, int(h.spawn_wp[0]), int(h.spawn_wp[d]))
             for d in range(1, got.num_spawn_points)]
    want_found = [j_routing.trace_route(want, int(h.spawn_wp[0]), int(h.spawn_wp[d]))
                  for d in range(1, got.num_spawn_points)]
    assert [r is None for r in found] == [r is None for r in want_found]
    assert any(r is not None for r in found)


def test_export_opendrive_is_byte_identical(osm_file, tmp_path):
    spec = josm.osm_to_graph(osm_file)
    josm.export_opendrive(spec, str(tmp_path / "jax.xodr"))
    tosm.export_opendrive(tosm.osm_to_graph(osm_file), str(tmp_path / "torch.xodr"))
    assert (tmp_path / "torch.xodr").read_bytes() == (tmp_path / "jax.xodr").read_bytes()
    assert (tmp_path / "torch.xodr").read_text().count("<road ") == len(spec.edges)


def test_landmarks_and_routes_match_jax(nets):
    want_net, got_net = nets
    want = jlm.landmarks_to_spawns(want_net, LANDMARKS, origin=ORIGIN)
    got = tlm.landmarks_to_spawns(got_net, LANDMARKS, origin=ORIGIN)
    assert got == want
    assert all(info["snap_dist_m"] < 60.0 for info in got.values())
    for num, sep in ((3, 50.0), (6, 100.0), (2, 0.0)):
        assert tlm.suggest_routes(got, num, sep) == jlm.suggest_routes(want, num, sep)
    assert "--spawn" in tlm.suggest_routes(got, 3, 50.0)[0]["cli"]


def test_build_map_reads_osm(osm_file):
    net = build_map(f"osm:{osm_file}")
    ref = tosm.load_osm_network(osm_file)
    assert net.num_waypoints == ref.num_waypoints > 50
    for f in dataclasses.fields(net):
        if f.name != "host":
            assert torch.equal(getattr(net, f.name), getattr(ref, f.name)), f.name
    with pytest.raises(SystemExit, match="osm:<path>"):
        build_map("nowhere")
