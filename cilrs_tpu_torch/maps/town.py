"""Procedural Town01-like map: a small-town street grid with T-junctions
(port of ``cilrs_tpu/maps/town.py``; the same numpy, so the same arrays).

CARLA's Town01 (the only town the reference drives/collects in —
model/autonomous_drive.py:562, model/collect_data.py:50) is a ~400x400 m
single-lane-per-direction grid town with T-intersections and traffic lights.
This generator reproduces those statistics procedurally: a grid of blocks with
a deterministic subset of interior streets removed (creating T-junctions),
one driving lane per direction, lights at every junction.
"""

from __future__ import annotations

import numpy as np

from cilrs_tpu_torch.maps.network import GraphSpec, RoadNetwork, build_network
from cilrs_tpu_torch.utils.profiling import span


def town01_graph(
    blocks_x: int = 5,
    blocks_y: int = 5,
    block_m: float = 85.0,
    seed: int = 7,
    lanes_per_dir: int = 1,
) -> GraphSpec:
    nx, ny = blocks_x + 1, blocks_y + 1
    xs = np.arange(nx) * block_m
    ys = np.arange(ny) * block_m
    nodes = np.array([[x, y] for y in ys for x in xs], np.float64)

    def nid(ix, iy):
        return iy * nx + ix

    rng = np.random.RandomState(seed)
    edges = []
    # Perimeter is always complete; interior streets are dropped ~30% of the
    # time to create T-junctions, Town01-style.
    for iy in range(ny):
        for ix in range(nx - 1):
            interior = 0 < iy < ny - 1
            if interior and rng.rand() < 0.3:
                continue
            edges.append((nid(ix, iy), nid(ix + 1, iy)))
    for ix in range(nx):
        for iy in range(ny - 1):
            interior = 0 < ix < nx - 1
            if interior and rng.rand() < 0.3:
                continue
            edges.append((nid(ix, iy), nid(ix, iy + 1)))

    # Drop nodes that ended up isolated (keep indices stable by keeping them
    # in the array; they simply have no edges).
    return GraphSpec(nodes=nodes, edges=edges, lanes_per_dir=lanes_per_dir)


@span("town_build")
def make_town01(
    blocks_x: int = 5,
    blocks_y: int = 5,
    block_m: float = 85.0,
    seed: int = 7,
    lanes_per_dir: int = 1,
    tex_scale: float = 0.5,
) -> RoadNetwork:
    spec = town01_graph(blocks_x, blocks_y, block_m, seed, lanes_per_dir)
    return build_network(spec, tex_scale=tex_scale)


def make_mini_town(seed: int = 7) -> RoadNetwork:
    """Tiny 2x2-block map for fast tests."""
    return make_town01(blocks_x=2, blocks_y=2, block_m=70.0, seed=seed, tex_scale=1.0)
