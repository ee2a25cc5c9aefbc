"""Parity of cilrs_tpu_torch.data.resident.collect_resident with the JAX
package's, on the mini town, and the resident pipeline through
``cli.pipeline --resident`` on the CPU.

Both packages collect the same fleet (same seed, envs, mixed weathers,
traffic, camera), once into one page and once into two pages forced by a
small ``max_page_bytes``. The pedestrians re-aim from random draws, and JAX's
PRNG and torch's generators draw different streams, so the port gets JAX's
own draws: each session's fleet generator is seeded with the session's seed,
from which the test derives JAX's per-env keys (``PRNGKey(seed * 997 + e)``,
split once a tick across the session's chunks). The camera is 64x64: its
12,288-byte rows need no padding in either package's layout, so one byte
limit gives both the same pages.

Tolerances: ``page_rows``, the page count, the pages' slots, env, tick,
command and light state exact; the normalized speed and the controls within
1e-6, speeds 1e-4 km/h, positions 1e-4 m, yaws and obstacle distances 1e-4
(the collect-mode rollout's tolerances, tests/test_torch_agent.py); the
table's frames: the clear env's rows as the collect tests hold them (at most
0.5% of the u8 values off by more than 1), and all rows within the
renderer's bounds (tests/test_torch_render.py: values off by more than 0.05
of the range, mean difference under 1e-3 of it) but with a 1% share. The
rain env's rows need it, and not for the sin hashes, which the port computes
as XLA does (ops/sinf.py): at this 64-pixel width the JAX program takes the
streak columns' phase, a hash of constants, with the argument rounded twice
and sin correctly rounded (tests/test_torch_sinf.py pins it), and a column
whose phase differs draws its streaks a row apart. Measured: 0.43%, 0.43%
and 0.73% of the values off by more than 0.05 (one page; two pages), the
rain env's rows 2.4-2.8% off by more than 1; with the port's phase computed
as that program computes it, 2e-5, 0 and 0. The session CSVs to
print precision (one unit of the last printed digit) but the wall-clock
timestamp, and summary.txt equal but its wall-time and rate lines.
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from cilrs_tpu.data import resident as jres  # noqa: E402
from cilrs_tpu.maps import routing as j_routing  # noqa: E402
from cilrs_tpu.maps.town import make_mini_town as j_mini  # noqa: E402
from cilrs_tpu.render.camera import CameraSpec as JCam  # noqa: E402
from cilrs_tpu_torch.cli import pipeline as pipeline_cli  # noqa: E402
from cilrs_tpu_torch.config import ModelConfig, TrainConfig, TrainingConfig  # noqa: E402
from cilrs_tpu_torch.data import collect as tcol  # noqa: E402
from cilrs_tpu_torch.data import resident as tres  # noqa: E402
from cilrs_tpu_torch.data.dataset import stratified_split  # noqa: E402
from cilrs_tpu_torch.evaluation.report import collect_predictions_resident  # noqa: E402
from cilrs_tpu_torch.maps.town import make_mini_town as t_mini  # noqa: E402
from cilrs_tpu_torch.render.camera import CameraSpec  # noqa: E402
from cilrs_tpu_torch.train.loop import train  # noqa: E402

E, V, P, T, SEED = 2, 4, 2, 20, 3
CAM = dict(width=64, height=64)
D = 64 * 64 * 3
# (frames, byte limit): one page, and two pages of 80 logical rows (120 slots
# a page under the limit: 80 rows + one chunk of E*T = 40 rows of slack).
LAYOUTS = {"one_page": (120, 2 ** 33), "two_pages": (160, 120 * D + 1)}
TOL = {"speed": 1e-6, "controls": 1e-6, "speed_kmh": 1e-4, "pos": 1e-4, "yaw": 1e-4,
       "obstacle_dist": 1e-4}
EXACT = ("command", "tl_state", "env", "tick")
# Frames, in u8 levels (see the module docstring): at most 1% of the values
# off by more than 0.05 of the range, the mean difference under 1e-3 of it;
# the clear env's rows: at most 0.5% of the values off by more than 1.
FRAME_ATOL, FRAME_MAX_SHARE, FRAME_MAX_MEAN = 0.05 * 255, 0.01, 1e-3 * 255
CLEAR_MAX_SHARE = 0.005
TINY_CFG = TrainConfig(model=ModelConfig(dropout=0.0, image_height=64, image_width=64,
                                         stage_sizes=(1, 1, 1, 1)),
                       training=TrainingConfig(batch_size=16, epochs=1))


@pytest.fixture(autouse=True)
def _fresh_jax_route_graphs():
    """The JAX package caches its host search graphs by id(net.wp_xy)
    (``cilrs_tpu/maps/routing.py:155-164``); each test starts and ends with
    that cache empty."""
    j_routing._graph_cache.clear()
    yield
    j_routing._graph_cache.clear()


def _session_draws(session_seed: int, steps: int) -> torch.Tensor:
    """JAX's pedestrian uniforms of one session's fleet: [steps, E, P]."""
    def chain(key):
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.uniform(sub, (P,))
        return jax.lax.scan(body, key, None, length=steps)[1]

    keys = jax.numpy.stack([jax.random.PRNGKey(session_seed * 997 + e) for e in range(E)])
    return torch.tensor(np.asarray(jax.vmap(chain)(keys)).transpose(1, 0, 2))


@pytest.fixture(scope="module", params=list(LAYOUTS))
def collected(request, tmp_path_factory):
    j_routing._graph_cache.clear()  # module fixtures run before the autouse one
    n, limit = LAYOUTS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    kw = dict(num_envs=E, num_vehicles=V, num_pedestrians=P, weather_idx=None, seed=SEED,
              chunk_steps=T, verbose=False, max_page_bytes=limit)
    want = jres.collect_resident(j_mini(), n, cam=JCam(**CAM), output_dir=str(root / "jax"), **kw)

    draws, served = {}, {}
    steps = 30 * T  # more chunks than a session of these sizes takes

    def jax_draws(generator, steps_, num_envs, num_pedestrians, device):
        assert (steps_, num_envs, num_pedestrians) == (T, E, P)
        s = generator.initial_seed()  # the session's seed
        if s not in draws:
            draws[s] = _session_draws(s, steps)
        k = served[s] = served.get(s, -1) + 1
        return draws[s][k * T:(k + 1) * T]

    mp = pytest.MonkeyPatch()
    mp.setattr(tcol, "draw_pedestrians", jax_draws)
    try:
        got = tres.collect_resident(t_mini(), n, cam=CameraSpec(**CAM),
                                    output_dir=str(root / "torch"), device="cpu", **kw)
    finally:
        mp.undo()
    return request.param, root, want, got, sorted(draws)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _digits(cell: str) -> int:
    return len(cell.split(".")[1]) if "." in cell else 0


def test_table_and_labels_match_jax(collected):
    layout, _, (jtable, jlabels, jstats), (table, labels, stats), sessions = collected
    n = LAYOUTS[layout][0]
    assert table["page_rows"] == jtable["page_rows"] and table["image_shape"] == (64, 64, 3)
    assert len(table["images"]) == len(jtable["images"]) == (1 if layout == "one_page" else 2)
    assert sessions == [SEED + 7919 * s for s in range(len(table["images"]))]
    assert stats["num_pages"] == jstats["num_pages"] and stats["frames"] == n
    pr = table["page_rows"]
    for p, (page, jpage) in enumerate(zip(table["images"], jtable["images"])):
        jpage = np.asarray(jpage).reshape(jpage.shape[0], -1)
        assert page.shape == jpage.shape and page.dtype == torch.uint8
        rows = pr if p < len(table["images"]) - 1 else n - p * pr
        d = np.abs(page[:rows].numpy().astype(int) - jpage[:rows].astype(int))
        assert (d > FRAME_ATOL).mean() <= FRAME_MAX_SHARE and d.mean() <= FRAME_MAX_MEAN, p
        clear = labels["env"][p * pr:p * pr + rows] % 5 == 0
        assert clear.any() and (d[clear] > 1).mean() <= CLEAR_MAX_SHARE, p
    assert set(labels) == set(jlabels)
    for k in EXACT:
        np.testing.assert_array_equal(labels[k], jlabels[k].astype(labels[k].dtype), err_msg=k)
    for k, tol in TOL.items():
        np.testing.assert_allclose(labels[k], jlabels[k], atol=tol, rtol=0, err_msg=k)
    for k in tres.LABEL_KEYS:
        np.testing.assert_array_equal(table[k].numpy(), labels[k], err_msg=k)
    assert (labels["speed_kmh"] > tcol.MIN_SPEED_KMH).all()
    assert len(set(labels["env"].tolist())) == E
    assert stats["command_distribution"] == jstats["command_distribution"]


def test_session_files_match_jax(collected):
    _, root, _, _, _ = collected
    jrows, trows = _rows(root / "jax" / "measurements.csv"), _rows(root / "torch" / "measurements.csv")
    assert trows[0] == jrows[0] and len(trows) == len(jrows)
    ts = jrows[0].index("timestamp")
    for jr_, tr_ in zip(jrows[1:], trows[1:]):
        for i, (a, b) in enumerate(zip(jr_, tr_)):
            if i == ts or a == b:
                continue
            assert _digits(a) == _digits(b) > 0, (jrows[0][i], a, b)
            assert abs(float(a) - float(b)) <= 1.01 * 10.0 ** -_digits(a), (jrows[0][i], a, b)
    assert _rows(root / "torch" / "aux.csv") == _rows(root / "jax" / "aux.csv")

    def summary(side):
        with open(root / side / "summary.txt") as f:
            return [ln for ln in f.read().splitlines()
                    if not ln.startswith(("Wall time", "Sim rate"))]
    assert summary("torch") == summary("jax")
    assert "Weather: mixed" in summary("torch")


def test_train_and_report_take_the_table(collected):
    _, _, _, (table, labels, _), _ = collected
    ds = tres.labels_dataset(labels)
    out = train(ds, TINY_CFG, device="cpu", steps_per_epoch=2, verbose=False, resident=table)
    assert np.isfinite(out["best_val_loss"]) and out["val_table"] is not None
    _, val_idx = stratified_split(ds, TINY_CFG.training.val_fraction, TINY_CFG.training.seed)
    pred, true, cmd = collect_predictions_resident(out["eval_state"].model.eval(), table, labels,
                                                   val_idx, 8, TINY_CFG)
    assert pred.shape == true.shape == (len(val_idx), 4) and np.isfinite(pred).all()
    np.testing.assert_array_equal(cmd, labels["command"][val_idx])
    # The gather reads the collected rows: one from every page.
    rows = np.array([0, table["page_rows"] - 1, len(labels["speed"]) - 1])
    got = tres.gather_group(table, rows)["images"].numpy()
    for r, g in zip(rows, got):
        page, local = divmod(int(r), table["page_rows"])
        np.testing.assert_array_equal(g.reshape(-1), table["images"][page][local, :D].numpy())


def _tiny_config(tmp_path):
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump({"model": {"dropout": 0.0, "stage_sizes": [1, 1, 1, 1]},
                   "training": {"batch_size": 8}}, f)
    return path


def test_cli_pipeline_resident_on_cpu(tmp_path):
    work = tmp_path / "work"
    timing = pipeline_cli.main([
        "--workdir", str(work), "--resident", "--frames", "160", "--envs", "2",
        "--vehicles", "3", "--walkers", "1", "--epochs", "1", "--map", "mini",
        "--bench-duration", "2", "--config", _tiny_config(tmp_path), "--device", "cpu"])
    with open(work / "pipeline_timing.json") as f:
        assert json.load(f) == json.loads(json.dumps(timing))
    assert {"collect_s", "collect_frames_per_sec", "train_s", "best_val_loss", "report_s",
            "bench_s", "total_s"} <= set(timing)
    with open(work / "evaluation_report.json") as f:
        report = json.load(f)
    assert report["num_samples"] > 0 and np.isfinite(report["steer"]["mae"])
    assert set(report["per_weather"]) <= {"clear", "rain", "fog", "night", "hardrain"}
    md = (work / "RESULTS.md").read_text().splitlines()
    assert md[0] == "# CILRS-TPU 5-Weather Closed-Loop Benchmark"
    assert sum(ln.startswith(("| Clear", "| Rain", "| Fog", "| Night", "| Hard Rain"))
               for ln in md) == 5
    with open(work / "benchmark.json") as f:
        bench = json.load(f)
    assert list(bench) == ["clear", "rain", "fog", "night", "hardrain"]
    assert all(np.isfinite(s["overall"]) for s in bench.values())
    assert len(_rows(work / "session_resident" / "measurements.csv")) == 161
    assert os.path.exists(work / "ckpt" / "checkpoint_best.pth")
