"""The port's collection analyses (``cilrs_tpu_torch/tools``) against the
repo's JAX tools (``tools/*.py``) on the same inputs, and the port's
``graft_entry`` against ``__graft_entry__.py``.

The JAX tools collect their own table through ``collect_resident`` on a
TPU. Here both packages' ``collect_resident`` (and ``build_map``) are
patched to hand over one synthetic collection, made with numpy from a seed
in ``collect_resident``'s format: 16 envs in weather e % 5, rows in (tick,
env) order, every label ``collect_resident`` returns, and a table of two
pages with slack rows (the JAX package's [S, R, 128] pages, the port's
[S, row] pages). A real collection on the CPU costs about 0.6 s a frame,
so the synthetic one stands in; the tools read the table and labels only.
``require_accelerator`` and ``enable_compilation_cache`` of
``cilrs_tpu.cli.common`` are patched to no-ops. The JAX tools' gathers run
in Pallas interpret mode, as the JAX package's own tests run them.

Tolerances:
 - ``label_noise_floor`` / ``corr_ceiling``: the sessions are written by
   the collectors' own CSV writers (the port's and the JAX package's
   ``_write_session_csv``). pandas' default float parser is not always
   correctly rounded and Python's ``float`` is, so a column may differ in
   the last bit (held to 1 ulp); on these CSVs the matched pairs are the
   same pairs in the same order, with and without aux.csv, with and
   without its env/tick columns, and with the ``max_pairs`` cap biting.
   The floors and ceilings agree within 1e-12 and print the same lines;
 - ``exp_label_structure``: on 176,256 rows (all three regions populated),
   the same numpy on the same labels: its JSON equal, its lines equal;
 - ``exp_image_stats``: 176,256 rows of 4x8x3 frames (two pages), the
   same picks read through the gather: counts exact, statistics within
   1e-6 relative;
 - ``exp_cross_eval``: 600 rows of 32x64 frames over two pages, a (1, 1,
   1, 1) CILRS in float32 on both sides (JAX's init, carried over by
   ``models/convert.py:flax_to_state_dict``): per-row predicted controls
   and the region and bucket MAEs within tests/test_torch_model.py's 1e-3,
   counts exact;
 - ``graft_entry.entry``: the full-width CILRS at batch 8, float32 on both
   sides, within tests/test_torch_model.py's tolerances (controls 1e-3;
   pred_speed 2e-3 + 1e-3 relative).
"""

import functools
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.cli.common as j_common  # noqa: E402
import cilrs_tpu.config as j_config  # noqa: E402
import cilrs_tpu.data.resident as j_resident  # noqa: E402
import cilrs_tpu.models as j_models  # noqa: E402
import cilrs_tpu.train.state as j_state  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.train import checkpoint as j_ckpt  # noqa: E402
from cilrs_tpu_torch import graft_entry  # noqa: E402
from cilrs_tpu_torch.config import SPEED_NORM_FACTOR  # noqa: E402
from cilrs_tpu_torch.data import resident as t_resident  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.ops.gather import padded_row_elems  # noqa: E402
from cilrs_tpu_torch.tools import (corr_ceiling, exp_cross_eval, exp_image_stats,  # noqa: E402
                                   exp_label_structure, label_noise_floor)
from cilrs_tpu_torch.train.checkpoint import save_checkpoint_pth  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = 16
FULL_ROWS = 176_256
PRED_TOL = dict(atol=1e-3, rtol=0)
SPEED_TOL = dict(atol=2e-3, rtol=1e-3)
STATS_RTOL = 1e-6
FLOOR_TOL = 1e-12


def jax_tool(name: str):
    """tools/<name>.py as a module (tools/ on the path, for its imports)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                      os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return mod


def synthetic_labels(n: int, seed: int, page_rows: int | None = None) -> dict:
    """``collect_resident``'s host labels for n rows: row k is env k % 16 at
    its session's tick k // 16 (a new session, ticks from 0, every page).
    The envs drive one 20 m circle in step, so states repeat across envs;
    steer arcs, commands, lights and obstacles change along it."""
    rng = np.random.RandomState(seed)
    k = np.arange(n)
    local = k if page_rows is None else k % page_rows
    env, tick = (local % ENVS).astype(np.int32), (local // ENVS).astype(np.int32)
    theta = 2 * np.pi * tick / 80.0
    pos = np.stack([20 * np.cos(theta), 20 * np.sin(theta)], 1) + rng.normal(0, 0.2, (n, 2))
    steer = 0.3 * np.sin(2 * np.pi * tick / 60.0 + env) + rng.normal(0, 0.02, n)
    speed_kmh = 15.0 + rng.normal(0, 0.5, n) + 3 * np.sin(env + tick / 40.0)
    ctrl = np.stack([steer, np.clip(rng.normal(0.5, 0.1, n), 0, 1),
                     np.clip(rng.normal(0.05, 0.05, n), 0, 1)], 1)
    near = rng.rand(n) < 0.2
    return {
        "speed": np.clip(speed_kmh / SPEED_NORM_FACTOR, 0, 1).astype(np.float32),
        "command": ((tick // 25 + env) % 4).astype(np.int32),
        "controls": ctrl.astype(np.float32),
        "speed_kmh": speed_kmh.astype(np.float32),
        "pos": pos.astype(np.float32),
        "yaw": (theta + np.pi / 2 + rng.normal(0, 0.01, n)).astype(np.float32),
        "obstacle_dist": np.where(near, 10 + rng.rand(n), 50.0).astype(np.float32),
        "tl_state": ((tick // 30) % 3 == 2).astype(np.int32),
        "env": env, "tick": tick,
    }


def synthetic_collection(n: int, image_shape: tuple, page_rows: int, seed: int,
                         slack: int = 37):
    """(pages as numpy [slots, D] u8, labels): night envs (weather 3) dark,
    hard rain dim, the rest bright; each page has ``slack`` zero rows after
    its logical rows."""
    rng = np.random.RandomState(seed)
    labels = synthetic_labels(n, seed, page_rows)
    d = int(np.prod(image_shape))
    base = np.array([120, 110, 130, 35, 70], np.int16)[labels["env"] % 5]
    pages = []
    for lo in range(0, n, page_rows):
        hi = min(lo + page_rows, n)
        page = np.zeros((hi - lo + slack, d), np.uint8)
        page[:hi - lo] = np.clip(base[lo:hi, None] + rng.randint(-60, 61, (hi - lo, d)), 0, 255)
        pages.append(page)
    return pages, labels


def jax_table(pages, page_rows: int, image_shape: tuple, labels: dict) -> dict:
    """The JAX package's table: [S, R, 128] u8 pages, rows zero-padded."""
    d = pages[0].shape[1]
    r = -(-d // 128)
    return {"images": tuple(jnp.asarray(np.pad(p, ((0, 0), (0, r * 128 - d))).reshape(-1, r, 128))
                            for p in pages),
            "page_rows": page_rows, "image_shape": image_shape,
            **{k: jnp.asarray(labels[k]) for k in ("speed", "command", "controls")}}


def port_table(pages, page_rows: int, image_shape: tuple, labels: dict) -> dict:
    """The port's table on the CPU: [S, row] u8 pages, rows padded to 16 B."""
    d = pages[0].shape[1]
    pad = padded_row_elems(d, torch.uint8) - d
    return {"images": tuple(torch.from_numpy(np.pad(p, ((0, 0), (0, pad)))) for p in pages),
            "page_rows": page_rows, "image_shape": image_shape,
            **{k: torch.from_numpy(labels[k]) for k in ("speed", "command", "controls")}}


def patch_collections(mp, pages, page_rows, image_shape, labels, port_modules):
    """Both packages' collect_resident -> this collection; the JAX entry
    helpers -> no-ops."""
    n = len(labels["env"])
    stats = {"num_pages": len(pages), "page_rows": page_rows, "frames_per_sec": 0.0}

    def collector(table):
        def collect(net, num_frames, **kw):
            assert num_frames == n and kw["num_envs"] == ENVS and kw["seed"] == 0, kw
            return table, labels, stats
        return collect

    mp.setattr(j_common, "require_accelerator", lambda *a, **k: None)
    mp.setattr(j_common, "enable_compilation_cache", lambda *a, **k: None)
    mp.setattr(j_common, "build_map", lambda spec: None)
    mp.setattr(j_resident, "collect_resident",
               collector(jax_table(pages, page_rows, image_shape, labels)))
    for mod in port_modules:
        mp.setattr(mod, "build_map", lambda spec: None)
        mp.setattr(mod, "collect_resident",
                   collector(port_table(pages, page_rows, image_shape, labels)))


# ---------------------------------------------------------------------------
# label_noise_floor, corr_ceiling
# ---------------------------------------------------------------------------


def _write_sessions(root, case: str) -> list:
    """Two resident sessions, one by each package's CSV writer; ``case``
    drops aux.csv ("no_aux") or its env and tick columns ("aux_no_env")."""
    paths = []
    for s, writer in ((1, t_resident._write_session_csv), (2, j_resident._write_session_csv)):
        labels = synthetic_labels(640, seed=s)
        stats = {"frames": 640, "wall_time_s": 1.0, "frames_per_sec": 640.0, "sim_hz": 1.0,
                 "command_distribution": {c: int((labels["command"] == i).sum())
                                          for i, c in enumerate(("A", "B", "C", "D"))}}
        path = str(root / f"session_{s}")
        writer(path, labels, stats, ENVS, None)
        aux = os.path.join(path, "aux.csv")
        if case == "no_aux":
            os.remove(aux)
        elif case == "aux_no_env":
            with open(aux) as f:
                rows = [ln.split(",")[:3] for ln in f.read().splitlines()]
            with open(aux, "w") as f:
                f.write("\n".join(",".join(r) for r in rows) + "\n")
        paths.append(path)
    return paths


@pytest.fixture(scope="module", params=["resident", "no_aux", "aux_no_env"])
def sessions(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    return request.param, _write_sessions(root, request.param)


def test_load_sessions_reads_what_pandas_reads(sessions):
    case, paths = sessions
    jdf = jax_tool("label_noise_floor").load_sessions(paths)
    df = label_noise_floor.load_sessions(paths)
    assert list(df) == list(jdf.columns)
    assert ("env" in df) == (case == "resident") and ("tl_state" in df) == (case != "no_aux")
    for k, want in jdf.items():
        want = want.to_numpy()
        assert df[k].dtype.kind == want.dtype.kind, k
        if want.dtype.kind == "f":
            np.testing.assert_array_max_ulp(df[k], want, maxulp=1)
        else:
            np.testing.assert_array_equal(df[k], want)


@pytest.mark.parametrize("cap", [200_000, 97])
def test_match_pairs_same_pairs_in_same_order(sessions, cap):
    case, paths = sessions
    jtool = jax_tool("label_noise_floor")
    for tol in ((0.75, 3.0, 1.5), (0.5, 2.0, 1.0)):  # the noise floor's and the ceiling's
        want = jtool.match_pairs(jtool.load_sessions(paths), *tol, max_pairs=cap)
        got = label_noise_floor.match_pairs(label_noise_floor.load_sessions(paths), *tol,
                                            max_pairs=cap)
        np.testing.assert_array_equal(got, want)
        if cap == 97:  # the cap bites: the first 97 pairs of the uncapped run
            full = label_noise_floor.match_pairs(label_noise_floor.load_sessions(paths), *tol)
            assert len(got) == cap < len(full), (case, tol, len(full))
            np.testing.assert_array_equal(got, full[:cap])
        else:
            assert len(got) > 97, (case, tol, len(got))


def _run_jax_main(mod, argv, mp, capsys):
    mp.setattr(sys, "argv", ["tool"] + argv)
    mod.main()
    return capsys.readouterr().out


def test_label_noise_floor_matches_jax(sessions, monkeypatch, capsys):
    _, paths = sessions
    jtool = jax_tool("label_noise_floor")
    want_out = _run_jax_main(jtool, paths, monkeypatch, capsys)
    got = label_noise_floor.main(paths + ["--device", "cpu"])
    assert capsys.readouterr().out == want_out
    jdf = jtool.load_sessions(paths)
    pairs = jtool.match_pairs(jdf)
    d = np.abs(jdf[["steer", "throttle", "brake"]].to_numpy()[pairs[:, 0]]
               - jdf[["steer", "throttle", "brake"]].to_numpy()[pairs[:, 1]]) / 2.0
    assert got["pairs"] == len(pairs) > 0 and got["frames"] == len(jdf)
    m = d.mean(axis=0)
    f = got["floors"]["all pairs"]
    np.testing.assert_allclose([f["steer_floor"], f["throttle_floor"], f["brake_floor"]], m,
                               rtol=0, atol=FLOOR_TOL)
    assert abs(got["controls_loss_floor"] - (5 * m[0] + m[1] + m[2])) <= FLOOR_TOL
    assert f["pairs"] == got["floors"]["big-steer (|s|>0.1)"]["pairs"] + \
        got["floors"]["small-steer"]["pairs"]


def test_corr_ceiling_matches_jax(sessions, monkeypatch, capsys):
    _, paths = sessions
    jtool = jax_tool("corr_ceiling")
    want_out = _run_jax_main(jtool, paths, monkeypatch, capsys)
    got = corr_ceiling.main(paths + ["--device", "cpu"])
    assert capsys.readouterr().out == want_out
    jfloor = jax_tool("label_noise_floor")
    jdf = jfloor.load_sessions(paths)
    pairs = jfloor.match_pairs(jdf, 0.5, 2.0, 1.0)
    labels = jdf[["steer", "throttle", "brake"]].to_numpy()
    for k, name in enumerate(("steer", "throttle", "brake")):
        var_eps = ((labels[pairs[:, 0], k] - labels[pairs[:, 1], k]) ** 2).mean() / 2.0
        ceil = np.sqrt(max(0.0, 1.0 - var_eps / labels[:, k].var()))
        assert abs(got["ceilings"][name]["corr_ceiling"] - ceil) <= FLOOR_TOL, name
        assert abs(got["ceilings"][name]["var_eps"] - var_eps) <= FLOOR_TOL, name
    d = np.abs(labels[pairs[:, 0], 0] - labels[pairs[:, 1], 0])
    assert got["ceilings"]["within_0.01_steer"]["p_scaled"] == float(
        (d / np.sqrt(2.0) <= 0.01).mean())


def test_noise_tools_refuse_cuda_without_a_gpu(sessions):
    _, paths = sessions
    for tool in (label_noise_floor, corr_ceiling):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tool.main(paths)


# ---------------------------------------------------------------------------
# exp_label_structure, exp_image_stats (176,256 rows, two pages)
# ---------------------------------------------------------------------------

TINY_FRAME = (4, 8, 3)
FULL_PAGE_ROWS = FULL_ROWS // 2


@pytest.fixture(scope="module")
def full_collection():
    pages, labels = synthetic_collection(FULL_ROWS, TINY_FRAME, FULL_PAGE_ROWS, seed=5)
    return pages, labels


def _jax_main_json(mod, argv, out_path, capsys):
    mod.main(argv + ["--out", str(out_path)])
    with open(out_path) as f:
        return json.load(f), capsys.readouterr().out


def test_exp_label_structure_matches_jax(full_collection, monkeypatch, capsys, tmp_path):
    pages, labels = full_collection
    patch_collections(monkeypatch, pages, FULL_PAGE_ROWS, TINY_FRAME, labels,
                      [exp_label_structure])
    want, want_out = _jax_main_json(jax_tool("exp_label_structure"), [], tmp_path / "j.json",
                                    capsys)
    got = exp_label_structure.main(["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.replace(str(tmp_path / "t.json"), "") == want_out.replace(
        str(tmp_path / "j.json"), "")
    assert json.loads(json.dumps(got)) == want
    assert [r["rows"] for r in want.values()] == [80_000, 70_000, FULL_ROWS - 150_000]
    assert all(r["turn_arcs"]["count"] > 0 for r in want.values())


def test_exp_image_stats_matches_jax(full_collection, monkeypatch, capsys, tmp_path):
    pages, labels = full_collection
    patch_collections(monkeypatch, pages, FULL_PAGE_ROWS, TINY_FRAME, labels, [exp_image_stats])
    want, _ = _jax_main_json(jax_tool("exp_image_stats"), [], tmp_path / "j.json", capsys)
    got = exp_image_stats.main(["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    assert list(got) == list(want) and all(len(v) == 5 for v in want.values())
    for region, cells in want.items():
        assert list(got[region]) == list(cells)
        for w, m in cells.items():
            g = got[region][w]
            assert g["n"] == m["n"] == 240
            np.testing.assert_allclose([g["mean"], g["std"], *g["rgb"], g["sat_frac"]],
                                       [m["mean"], m["std"], *m["rgb"], m["sat_frac"]],
                                       rtol=STATS_RTOL, atol=0)
    # Night (env % 5 == 3) frames are the dark ones: the picks read the rows.
    assert got["tail_>=150k"]["night"]["mean"] < 60 < got["tail_>=150k"]["clear"]["mean"]


# ---------------------------------------------------------------------------
# exp_cross_eval
# ---------------------------------------------------------------------------

EVAL_FRAME = (32, 64, 3)
EVAL_ROWS, EVAL_PAGE_ROWS = 600, 300
TINY_STAGES = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of weights twice: a JAX checkpoint directory (orbax, best
    slot) and the port's .pth; JAX's init from PRNGKey(0), float32."""
    import types

    jm = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=TINY_STAGES, speed_skip=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1,) + EVAL_FRAME),
                               jnp.zeros((1,)), jnp.zeros((1,), jnp.int32)))
    root = tmp_path_factory.mktemp("ckpt")
    j_ckpt.save_checkpoint(str(root / "jax"), types.SimpleNamespace(
        step=0, params=v["params"], batch_stats=v["batch_stats"], opt_state={}),
        epoch=1, val_loss=0.0, is_best=True, latest=False)
    model = CILRS(dropout=0.0, dtype=torch.float32, stage_sizes=TINY_STAGES, speed_skip=True)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    save_checkpoint_pth(str(root / "policy.pth"), model, 1, 0.0)
    return jm, str(root / "jax"), str(root / "policy.pth")


def test_exp_cross_eval_matches_jax(checkpoints, monkeypatch, capsys, tmp_path):
    jm, jax_ckpt, pth = checkpoints
    pages, labels = synthetic_collection(EVAL_ROWS, EVAL_FRAME, EVAL_PAGE_ROWS, seed=11)
    patch_collections(monkeypatch, pages, EVAL_PAGE_ROWS, EVAL_FRAME, labels, [exp_cross_eval])
    jcfg = j_config.TrainConfig(model=j_config.ModelConfig(dropout=0.0, stage_sizes=TINY_STAGES))
    monkeypatch.setattr(j_config, "load_train_config", lambda *a: jcfg)
    monkeypatch.setattr(j_state, "create_train_state", lambda cfg, rng, *a, **k:
                        j_state.CILRSTrainState(step=jnp.zeros((), jnp.int32), params=None,
                                                batch_stats=None, opt_state=None, tx=None,
                                                apply_fn=jm.apply))
    want, _ = _jax_main_json(jax_tool("exp_cross_eval"),
                             ["--ckpt", jax_ckpt, "--frames", str(EVAL_ROWS),
                              "--save-preds", str(tmp_path / "j.npz")], tmp_path / "j.json", capsys)
    got = exp_cross_eval.main(["--ckpt", pth, "--frames", str(EVAL_ROWS), "--device", "cpu",
                               "--save-preds", str(tmp_path / "t.npz"),
                               "--out", str(tmp_path / "t.json")])
    jp, tp = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert set(jp.files) == set(tp.files)
    np.testing.assert_allclose(tp["pred"], jp["pred"], **PRED_TOL)
    for k in jp.files:
        if k != "pred":
            np.testing.assert_array_equal(tp[k], jp[k])
    got = json.loads(json.dumps(got))
    assert {k: got[k] for k in ("frames", "page_rows")} == {"frames": EVAL_ROWS,
                                                            "page_rows": EVAL_PAGE_ROWS}
    assert want["frames"] == EVAL_ROWS and want["page_rows"] == EVAL_PAGE_ROWS

    def close(a, b, path):
        if isinstance(b, dict):
            assert list(a) == list(b), path
            for k in b:
                close(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{path}[{i}]")
        elif isinstance(b, float) and np.isfinite(b):
            assert abs(a - b) <= PRED_TOL["atol"], (path, a, b)
        elif isinstance(b, float):
            assert not np.isfinite(a), path
        else:
            assert a == b, path

    close(got["regions"], want["regions"], "regions")
    close(got["buckets_8k"], want["buckets_8k"], "buckets_8k")
    assert got["regions"]["page1_(shared_prefix)"]["LEFT_n"] > 0


def test_cross_eval_pads_the_last_group_and_drops_the_tail():
    """1,210 rows: 10 batches (one short group padded with copies of its last
    batch), the 10-row tail dropped; every row's prediction is its own."""
    pages, labels = synthetic_collection(1210, EVAL_FRAME, 700, seed=3)
    table = port_table(pages, 700, EVAL_FRAME, labels)
    model = CILRS(dropout=0.0, dtype=torch.float32, stage_sizes=TINY_STAGES).eval()
    seen = []
    model.register_forward_hook(lambda m, a, out: seen.append(a[0].shape[0]))
    preds = exp_cross_eval.score_rows(model, table, 1210)
    assert preds.shape == (1200, 3) and seen == [exp_cross_eval.B] * exp_cross_eval.K
    rows = np.array([5, 299, 700, 701, 1199])
    x = np.concatenate(pages)[np.r_[rows[:2], rows[2:] + 37]].reshape((-1,) + EVAL_FRAME)
    from cilrs_tpu_torch.ops.image import normalize

    with torch.inference_mode():
        want, _ = model(normalize(torch.from_numpy(x).float() / 255.0),
                        table["speed"][rows], table["command"][rows])
    np.testing.assert_allclose(preds[rows], want.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# graft_entry
# ---------------------------------------------------------------------------


def test_graft_entry_matches_the_jax_entry(monkeypatch):
    monkeypatch.setattr(j_models, "CILRS", functools.partial(JCILRS, dtype=jnp.float32))
    spec = importlib.util.spec_from_file_location("_jax_graft", os.path.join(REPO,
                                                                             "__graft_entry__.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    jfn, jargs = jmod.entry()
    fn, args = graft_entry.entry("cpu")
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs] == [
        (8, 88, 200, 3), (8,), (8,)]
    assert [str(a.dtype) for a in args] == ["torch.float32", "torch.float32", "torch.int32"]
    jm = JCILRS(dropout=0.0, dtype=jnp.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), *jargs, train=False))
    fn, _ = graft_entry.entry("cpu", state_dict=flax_to_state_dict(v["params"],
                                                                   v["batch_stats"]))
    rng = np.random.RandomState(0)
    img = rng.uniform(-2, 2, (8, 88, 200, 3)).astype(np.float32)
    speed = rng.uniform(0, 1, 8).astype(np.float32)
    cmd = rng.randint(0, 4, 8).astype(np.int32)
    want_c, want_s = (np.asarray(x) for x in jfn(jnp.asarray(img), jnp.asarray(speed),
                                                  jnp.asarray(cmd)))
    got_c, got_s = fn(torch.from_numpy(img), torch.from_numpy(speed), torch.from_numpy(cmd))
    np.testing.assert_allclose(got_c.numpy(), want_c, **PRED_TOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, **SPEED_TOL)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        graft_entry.entry()


def test_graft_dryrun_multichip_two_ranks(capsys):
    res = graft_entry.dryrun_multichip(2)
    assert np.isfinite(res["train_loss"]) and np.isfinite(res["fused_val_loss"])
    assert len(res["fleet_distances"]) == 4 and min(res["fleet_distances"]) > 1.0
    assert "dryrun_multichip(2): train loss" in capsys.readouterr().out


def test_tools_keep_the_jax_tools_flags():
    """Each port's flags are the JAX tool's, plus --device."""
    for name in ("label_noise_floor", "corr_ceiling", "exp_label_structure", "exp_image_stats",
                 "exp_cross_eval", "exp_band_arms", "exp_big_table_control", "exp_200k_bisect",
                 "exp_tail_poison", "exp_table_integrity", "exp_train_gather_probe",
                 "exp_page2_identity", "exp_eval_page_mutation", "exp_eval_sideeffect",
                 "exp_dispatch_divergence"):
        src = open(os.path.join(REPO, "tools", f"{name}.py")).read()
        port_src = open(os.path.join(REPO, "cilrs_tpu_torch", "tools", f"{name}.py")).read()
        flags = sorted(set(ln.split('"')[1] for ln in src.splitlines()
                           if "add_argument(" in ln))
        port_flags = sorted(set(ln.split('"')[1] for ln in port_src.splitlines()
                                if "add_argument(" in ln))
        assert port_flags == sorted(flags + ["--device"]), name
