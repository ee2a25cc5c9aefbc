"""Parity of cilrs_tpu_torch.data.collect.collect_session and cli.collect with
the JAX package's collection, on the mini town.

Both packages collect the same session (same seed, envs, traffic, camera).
The pedestrians re-aim from random draws, and JAX's PRNG and torch's
generators draw different streams, so the port is given JAX's own draws: the
test computes them from JAX's per-env keys (``PRNGKey(seed * 1000 + e)``, split
once a tick across chunks) and hands them to the port's chunk in place of its
generator's. (The JAX renderer cannot run without walkers: its walker pass
reduces over an empty axis.)

Tolerances: measurements.csv rows agree to print precision, one unit of the
last printed digit (1e-6 for controls and normalized speed, 1e-3 for speed,
position and yaw), except the wall-clock ``timestamp``; aux.csv equal;
summary.txt equal but for its wall time and throughput; the frames within the
renderer's tolerance (tests/test_torch_render.py): at most 0.5% of the u8
values differ by more than 1.
"""

import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from cilrs_tpu.data import collect as jc  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.maps.town import make_mini_town as j_mini  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu_torch.cli import collect as collect_cli  # noqa: E402
from cilrs_tpu_torch.data import collect as tcol  # noqa: E402
from cilrs_tpu_torch.data.dataset import CSV_HEADER, load_sessions  # noqa: E402
from cilrs_tpu_torch.maps.town import make_mini_town as t_mini  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402

E, V, P, T, SEED = 2, 4, 2, 40, 5
FRAMES = 100
CAM = dict(width=64, height=32)


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy)
    (``cilrs_tpu/maps/routing.py:155-164``): a network freed by an earlier test
    can hand its id, and so its graph, to a new one. Each test here starts and
    ends with that cache empty."""
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


def _digits(cell: str) -> int:
    return len(cell.split(".")[1]) if "." in cell else 0


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    j_routing._graph_cache.clear()  # module fixtures run before the autouse one
    root = tmp_path_factory.mktemp("collect")
    want = jc.collect_session(j_mini(), str(root / "jax"), num_frames=FRAMES, num_envs=E,
                              num_vehicles=V, num_pedestrians=P, seed=SEED, chunk_steps=T,
                              cam=JCam(**CAM), verbose=False)

    def chain(key, steps):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]

    chunks = 4
    keys = jax.numpy.stack([jax.random.PRNGKey(SEED * 1000 + e) for e in range(E)])
    draws = torch.from_numpy(np.ascontiguousarray(
        np.asarray(jax.vmap(lambda k: chain(k, T * chunks))(keys)).transpose(1, 0, 2)))
    served = []

    def jax_draws(generator, steps, num_envs, num_pedestrians, device):
        assert (steps, num_envs, num_pedestrians) == (T, E, P)
        k = len(served)
        served.append(k)
        return draws[k * T:(k + 1) * T]

    mp = pytest.MonkeyPatch()
    mp.setattr(tcol, "draw_pedestrians", jax_draws)
    try:
        got = tcol.collect_session(t_mini(), str(root / "torch"), num_frames=FRAMES, num_envs=E,
                                   num_vehicles=V, num_pedestrians=P, seed=SEED, chunk_steps=T,
                                   cam=CameraSpec(**CAM), verbose=False, device="cpu")
    finally:
        mp.undo()
    assert 0 < len(served) <= chunks
    return root, want, got


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_measurements_csv_matches_jax(sessions):
    root, want, got = sessions
    jrows, trows = _rows(root / "jax" / "measurements.csv"), _rows(root / "torch" / "measurements.csv")
    assert trows[0] == jrows[0] == CSV_HEADER
    assert len(trows) == len(jrows) == got["frames"] + 1 == want["frames"] + 1
    assert got["frames"] >= FRAMES
    ts_col = CSV_HEADER.index("timestamp")
    for jr_, tr_ in zip(jrows[1:], trows[1:]):
        for i, (a, b) in enumerate(zip(jr_, tr_)):
            if i == ts_col:
                continue
            if a == b:
                continue
            assert _digits(a) == _digits(b) > 0, (CSV_HEADER[i], a, b)
            assert abs(float(a) - float(b)) <= 1.01 * 10.0 ** -_digits(a), (CSV_HEADER[i], a, b)
    assert got["command_distribution"] == want["command_distribution"]


def test_aux_csv_and_summary_match_jax(sessions):
    root, _, _ = sessions
    assert _rows(root / "torch" / "aux.csv") == _rows(root / "jax" / "aux.csv")
    assert _rows(root / "torch" / "aux.csv")[0] == ["frame", "obstacle_dist", "tl_state"]

    def summary(side):
        with open(root / side / "summary.txt") as f:
            return [ln for ln in f.read().splitlines()
                    if not ln.startswith(("Wall time", "Throughput"))]
    assert summary("torch") == summary("jax")


def test_frames_match_jax(sessions):
    root, _, _ = sessions
    shards = sorted(p for p in os.listdir(root / "jax") if p.endswith(".npz"))
    assert shards == sorted(p for p in os.listdir(root / "torch") if p.endswith(".npz"))
    for s in shards:
        want = np.load(root / "jax" / s)["frames"]
        got = np.load(root / "torch" / s)["frames"]
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (np.abs(got.astype(int) - want.astype(int)) > 1).mean() <= 0.005


@pytest.mark.parametrize("fmt", ["npz", "jpeg"])
def test_cli_collect_on_cpu_writes_a_session(tmp_path, fmt):
    out = tmp_path / "session"
    stats = collect_cli.main(["--out", str(out), "--frames", "40", "--envs", "2", "--vehicles", "3",
                              "--walkers", "1", "--map", "mini", "--weather", "night",
                              "--format", fmt, "--device", "cpu"])
    assert stats["frames"] >= 40
    names = [r[1] for r in _rows(out / "measurements.csv")[1:]]
    if fmt == "npz":
        assert all(n.startswith("frames_") and "#" in n for n in names)
    else:
        assert all(n.endswith(".jpg") and (out / n).exists() for n in names)
    ds = load_sessions([str(out)])
    assert ds.images.shape == (stats["frames"], 88, 200, 3) and ds.images.dtype == np.uint8
    assert np.isfinite(ds.controls).all() and (ds.speed_norm > 0).all()
    assert set(np.unique(ds.command)) <= {0, 1, 2, 3}
    with open(out / "summary.txt") as f:
        assert "Weather:        night" in f.read()


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcol.collect_session(t_mini(), str(tmp_path / "s"), num_frames=10, num_envs=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        collect_cli.main(["--out", str(tmp_path / "s"), "--map", "mini"])
