"""OSM import: OpenStreetMap XML -> RoadNetwork (port of ``cilrs_tpu/maps/osm.py``).

Capability parity with the reference's campus-map toolchain (osm_to_xodr.py
+ load_cusat.py): parse OSM nodes and ways, keep drivable highway types, clip
to a bounding box, project lat/lon with the same equirectangular formula
(osm_to_xodr.py:26-41), drop roads shorter than 5 m (:163-167), then feed the
node/edge graph straight into the network builder. An OpenDRIVE 1.4 exporter
(``export_opendrive``) writes the reference's output format.

Host numpy and ``xml.etree``; the network is built on the CPU, and callers
move it with ``.to(device)``.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np

from cilrs_tpu_torch.maps.network import GraphSpec, RoadNetwork, build_network

# Drivable highway types (reference osm_to_xodr.py:81-85).
HIGHWAY_TYPES = {
    "motorway", "trunk", "primary", "secondary", "tertiary", "unclassified",
    "residential", "service", "living_street", "motorway_link", "trunk_link",
    "primary_link", "secondary_link", "tertiary_link",
}
EARTH_RADIUS = 6371000.0
MIN_ROAD_LEN = 5.0


def lat_lon_to_xy(lat: float, lon: float, lat0: float, lon0: float) -> tuple[float, float]:
    """Equirectangular projection around (lat0, lon0) — osm_to_xodr.py:26-41."""
    x = math.radians(lon - lon0) * EARTH_RADIUS * math.cos(math.radians(lat0))
    y = math.radians(lat - lat0) * EARTH_RADIUS
    return x, y


def parse_osm(path: str, bounds: tuple[float, float, float, float] | None = None):
    """Parse OSM XML. bounds = (min_lat, min_lon, max_lat, max_lon) or None.

    Returns (nodes dict id -> (lat, lon), ways list of node-id lists).
    """
    root = ET.parse(path).getroot()
    nodes: dict[str, tuple[float, float]] = {}
    for n in root.findall("node"):
        lat, lon = float(n.get("lat")), float(n.get("lon"))
        if bounds is not None and not (bounds[0] <= lat <= bounds[2] and bounds[1] <= lon <= bounds[3]):
            continue
        nodes[n.get("id")] = (lat, lon)
    ways = []
    for w in root.findall("way"):
        tags = {t.get("k"): t.get("v") for t in w.findall("tag")}
        if tags.get("highway") not in HIGHWAY_TYPES:
            continue
        nds = [nd.get("ref") for nd in w.findall("nd") if nd.get("ref") in nodes]
        if len(nds) >= 2:
            ways.append(nds)
    return nodes, ways


def osm_to_graph(path: str, bounds=None) -> GraphSpec:
    nodes, ways = parse_osm(path, bounds)
    if not ways:
        raise ValueError(f"no drivable ways found in {path}")
    lats = [ll[0] for ll in nodes.values()]
    lons = [ll[1] for ll in nodes.values()]
    lat0, lon0 = (min(lats) + max(lats)) / 2, (min(lons) + max(lons)) / 2

    idx: dict[str, int] = {}
    coords: list[tuple[float, float]] = []

    def node_idx(nid: str) -> int:
        if nid not in idx:
            idx[nid] = len(coords)
            coords.append(lat_lon_to_xy(*nodes[nid], lat0, lon0))
        return idx[nid]

    edges = []
    seen = set()
    for way in ways:
        for a, b in zip(way[:-1], way[1:]):
            pa = np.asarray(lat_lon_to_xy(*nodes[a], lat0, lon0))
            pb = np.asarray(lat_lon_to_xy(*nodes[b], lat0, lon0))
            if np.linalg.norm(pb - pa) < MIN_ROAD_LEN:
                continue
            ia, ib = node_idx(a), node_idx(b)
            key = (min(ia, ib), max(ia, ib))
            if key in seen or ia == ib:
                continue
            seen.add(key)
            edges.append((ia, ib))
    if not edges:
        raise ValueError("OSM graph has no usable edges")
    return GraphSpec(nodes=np.asarray(coords, np.float64), edges=edges)


def load_osm_network(path: str, bounds=None, tex_scale: float = 0.5,
                     with_lights: bool = True) -> RoadNetwork:
    """OSM file -> ready-to-drive RoadNetwork (load_cusat.py parity: the
    reference's world generation and spawn-point census happen in
    build_network)."""
    return build_network(osm_to_graph(path, bounds), tex_scale=tex_scale, with_lights=with_lights)


def export_opendrive(spec: GraphSpec, path: str):
    """Emit minimal OpenDRIVE 1.4 (line planViews, 2+2 lanes) like
    osm_to_xodr.py:202-291, for interoperability with OpenDRIVE consumers."""
    nodes = np.asarray(spec.nodes)
    parts = ['<?xml version="1.0" encoding="UTF-8"?>',
             '<OpenDRIVE>',
             '  <header revMajor="1" revMinor="4" name="cilrs_tpu export" version="1.00"/>']
    for rid, (i, j) in enumerate(spec.edges, start=1):
        a, b = nodes[i], nodes[j]
        d = b - a
        length = float(np.linalg.norm(d))
        hdg = math.atan2(d[1], d[0])
        parts += [
            f'  <road name="road{rid}" length="{length:.4f}" id="{rid}" junction="-1">',
            "    <planView>",
            f'      <geometry s="0.0" x="{a[0]:.4f}" y="{a[1]:.4f}" hdg="{hdg:.6f}" length="{length:.4f}">',
            "        <line/>",
            "      </geometry>",
            "    </planView>",
            '    <lanes><laneSection s="0.0">',
            '      <left>'
            '<lane id="2" type="sidewalk" level="false"><width sOffset="0.0" a="2.0" b="0" c="0" d="0"/></lane>'
            '<lane id="1" type="driving" level="false"><width sOffset="0.0" a="3.5" b="0" c="0" d="0"/></lane>'
            "</left>",
            '      <center><lane id="0" type="none" level="false"/></center>',
            '      <right>'
            '<lane id="-1" type="driving" level="false"><width sOffset="0.0" a="3.5" b="0" c="0" d="0"/></lane>'
            '<lane id="-2" type="sidewalk" level="false"><width sOffset="0.0" a="2.0" b="0" c="0" d="0"/></lane>'
            "</right>",
            "    </laneSection></lanes>",
            "  </road>",
        ]
    parts.append("</OpenDRIVE>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
