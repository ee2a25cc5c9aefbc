"""The port's table audits and training-arm tools (``cilrs_tpu_torch/tools``)
against the repo's JAX tools (``tools/*.py``) on the same inputs.

As in tests/test_torch_analysis.py, both packages' ``collect_resident``
(and ``build_map``) are patched to hand over one synthetic collection made
with numpy from a seed in ``collect_resident``'s format (16 envs in weather
e % 5, rows in (tick, env) order, pages with slack rows), and the JAX entry
helpers ``require_accelerator`` / ``enable_compilation_cache`` to no-ops;
the JAX gathers run in Pallas interpret mode.

 - ``exp_checksum``: a 300-row collection that is the prefix of a 600-row
   one (32x64x3 frames, so the weights ``arange(D) % 251 + 1`` wrap), then
   the same with one byte of small row 123 changed: every checksum exact
   (int64 here, uint32 there, under 2^32 either way), the write and read
   mismatches the same rows; the port's row length and 2^33 line its own;
 - ``exp_paged_audit``: the JAX tool's fixed 176,256 rows over two pages
   (4x8x3 frames; the tool reads any row length; JAX's gather through its
   plain reference, XLA's clamped ``table[idx]``, as tests/test_pallas.py
   holds the kernel to it, since interpret mode takes 7 s a 4,096-row
   batch here): zero mismatching
   checksums on both sides, and the weather oracle's mismatches the same
   rows (its counts by 20k rows, page and env equal; its medians divide by
   the port's 96-B row, JAX's by its padded 128-B row);
 - the arm tools (``exp_seed_arms``, ``exp_row_region``,
   ``exp_size_bisect``, ``exp_stage2``, ``exp_noeval_train``): ``train``
   patched on both sides to record its arguments; each arm's labels, mask,
   config and seeds exact; then one real arm of ``exp_seed_arms`` (a
   (1, 1, 1, 1) CILRS, one epoch) in each package, each through its own
   resident train loop.
"""

import dataclasses
import functools
import json
import os
import re
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.cli.common as j_common  # noqa: E402
import cilrs_tpu.config as j_config  # noqa: E402
import cilrs_tpu.data.resident as j_resident  # noqa: E402
import cilrs_tpu.ops.gather as j_gather  # noqa: E402
import cilrs_tpu.train.loop as j_loop  # noqa: E402
from cilrs_tpu.parallel.mesh import make_mesh  # noqa: E402
from cilrs_tpu_torch import config as t_config  # noqa: E402
from cilrs_tpu_torch.data.resident import unwrap_monolithic  # noqa: E402
from cilrs_tpu_torch.ops.gather import padded_row_elems  # noqa: E402
from cilrs_tpu_torch.tools import (arms, exp_checksum, exp_noeval_train,  # noqa: E402
                                   exp_paged_audit, exp_row_region, exp_seed_arms,
                                   exp_size_bisect, exp_stage2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = 16
SLACK = 29
FRAME = (32, 64, 3)
TINY_FRAME = (4, 8, 3)


def synthetic(n: int, image_shape: tuple, page_rows: int, seed: int):
    """(pages [slots, D] u8 with SLACK zero rows each, labels): row k is env
    k % 16 at tick k // 16 of its page's session; night (weather 3) dark,
    hard rain dim."""
    rng = np.random.RandomState(seed)
    local = np.arange(n) % page_rows
    env, tick = (local % ENVS).astype(np.int32), (local // ENVS).astype(np.int32)
    speed_kmh = rng.uniform(3, 30, n).astype(np.float32)
    labels = {"speed": (speed_kmh / t_config.SPEED_NORM_FACTOR).astype(np.float32),
              "command": rng.randint(0, 4, n).astype(np.int32),
              "controls": np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(0, 1, n),
                                    rng.uniform(0, 0.3, n)], 1).astype(np.float32),
              "speed_kmh": speed_kmh, "pos": rng.uniform(0, 300, (n, 2)).astype(np.float32),
              "yaw": rng.uniform(-3, 3, n).astype(np.float32),
              "obstacle_dist": rng.uniform(5, 60, n).astype(np.float32),
              "tl_state": rng.randint(0, 3, n).astype(np.int32), "env": env, "tick": tick}
    d = int(np.prod(image_shape))
    base = np.array([120, 110, 130, 35, 85], np.int16)[env % 5]
    pages = []
    for lo in range(0, n, page_rows):
        hi = min(lo + page_rows, n)
        page = np.zeros((hi - lo + SLACK, d), np.uint8)
        page[:hi - lo] = np.clip(base[lo:hi, None] + rng.randint(-60, 61, (hi - lo, d)), 0, 255)
        pages.append(page)
    return pages, labels


def tables(pages, page_rows: int, image_shape: tuple, labels: dict):
    """(the JAX package's table: [S, R, 128] pages; the port's: [S, row])."""
    d = pages[0].shape[1]
    r = -(-d // 128)
    pad = padded_row_elems(d, torch.uint8) - d
    lab = ("speed", "command", "controls")
    jt = {"images": tuple(jnp.asarray(np.pad(p, ((0, 0), (0, r * 128 - d))).reshape(-1, r, 128))
                          for p in pages),
          "page_rows": page_rows, "image_shape": image_shape,
          **{k: jnp.asarray(labels[k]) for k in lab}}
    tt = {"images": tuple(torch.from_numpy(np.pad(p, ((0, 0), (0, pad)))) for p in pages),
          "page_rows": page_rows, "image_shape": image_shape,
          **{k: torch.from_numpy(labels[k]) for k in lab}}
    return jt, tt


def patch(mp, by_frames: dict, port_modules, calls: list | None = None):
    """collect_resident of both packages -> the collection of ``by_frames``
    for the frames asked ({frames: (pages, page_rows, shape, labels)})."""
    built = {n: tables(*c) for n, c in by_frames.items()}

    def collector(side):
        def collect(net, num_frames, **kw):
            if calls is not None:
                calls.append((side, num_frames, kw.get("num_envs"), kw.get("seed"),
                              os.environ.get("CILRS_TPU_ALLOW_BIG_TABLE")))
            pages, page_rows, _, labels = by_frames[num_frames]
            stats = {"num_pages": len(pages), "page_rows": page_rows}
            return built[num_frames][side], labels, stats
        return collect

    mp.setattr(j_common, "require_accelerator", lambda *a, **k: None)
    mp.setattr(j_common, "enable_compilation_cache", lambda *a, **k: None)
    mp.setattr(j_common, "build_map", lambda spec: None)
    mp.setattr(j_resident, "collect_resident", collector(0))
    for mod in port_modules:
        mp.setattr(mod, "build_map", lambda spec: None)
        mp.setattr(mod, "collect_resident", collector(1))


def jax_module(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# unwrap_monolithic, exp_checksum
# ---------------------------------------------------------------------------


def test_unwrap_monolithic_matches_jax():
    pages, labels = synthetic(40, TINY_FRAME, 40, seed=1)
    jt, tt = tables(pages, 40, TINY_FRAME, labels)
    got, want = unwrap_monolithic(tt), j_resident.unwrap_monolithic(jt)
    assert set(got) == set(want) and got["images"] is tt["images"][0]
    assert "images" in tt and isinstance(tt["images"], tuple)  # the input is not changed
    np.testing.assert_array_equal(got["images"].numpy()[:, :96],
                                  np.asarray(want["images"]).reshape(len(pages[0]), -1)[:, :96])
    two, _ = synthetic(40, TINY_FRAME, 20, seed=1)
    with pytest.raises(ValueError):
        unwrap_monolithic(tables(two, 20, TINY_FRAME, labels)[1])


@pytest.fixture(scope="module")
def checksum_collections():
    big_pages, big_labels = synthetic(600, FRAME, 600, seed=2)
    small = [big_pages[0][:300].copy()]
    small[0] = np.concatenate([small[0], np.zeros((SLACK, small[0].shape[1]), np.uint8)])
    small_labels = {k: v[:300] for k, v in big_labels.items()}
    return {600: (big_pages, 600, FRAME, big_labels), 300: (small, 300, FRAME, small_labels)}


@pytest.mark.parametrize("corrupt", [False, True])
def test_exp_checksum_matches_jax(checksum_collections, corrupt, monkeypatch, tmp_path, capsys):
    cols = dict(checksum_collections)
    if corrupt:  # one byte of small row 123: a write-side mismatch there
        pages = [cols[300][0][0].copy()]
        pages[0][123, 4_000] ^= 0x5A
        cols[300] = (pages,) + cols[300][1:]
    calls = []
    # Recorded as absent, so that teardown removes the value the JAX tool sets.
    monkeypatch.setenv("CILRS_TPU_ALLOW_BIG_TABLE", "0")
    monkeypatch.delenv("CILRS_TPU_ALLOW_BIG_TABLE")
    patch(monkeypatch, cols, [exp_checksum], calls)
    # The JAX tool sets CILRS_TPU_ALLOW_BIG_TABLE=1 when it is imported.
    jtool = jax_module("exp_checksum")
    argv = ["--small", "300", "--big", "600", "--batch", "64"]
    jtool.main(argv + ["--out", str(tmp_path / "j.json")])
    monkeypatch.delenv("CILRS_TPU_ALLOW_BIG_TABLE")
    got = exp_checksum.main(argv + ["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    assert "CILRS_TPU_ALLOW_BIG_TABLE" not in os.environ  # restored after the run
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == got
    # Both packages collected small then big with the switch on.
    assert calls == [(0, 300, 16, 0, "1"), (0, 600, 16, 0, "1"),
                     (1, 300, 16, 0, "1"), (1, 600, 16, 0, "1")]
    assert {k: got[k] for k in ("small", "big", "write_mismatches", "write_first",
                                "read_mismatches", "read_first")} == \
        {k: want[k] for k in ("small", "big", "write_mismatches", "write_first",
                              "read_mismatches", "read_first")}
    assert got["write_first"] == ([123] if corrupt else []) and got["read_mismatches"] == 0
    # The row length (the synthetic JAX pages are [S, 48, 128], unpadded).
    assert got["row_bytes"] == want["row_bytes"] == 6144
    assert got["wrap_row"] == 2 ** 33 / 6144
    out = capsys.readouterr().out
    assert out.count("WRITE audit: ") == 2 and out.count("READ audit: 0 / 600") == 2


def test_checksums_equal_jax_sums():
    """Row sums through the gather and through slices, paged, against
    uint32 sums in numpy (JAX's arithmetic) on full-size frames."""
    pages, _ = synthetic(50, (88, 200, 3), 30, seed=4)
    tp = tuple(torch.from_numpy(p) for p in pages)
    s_g, h_g = exp_checksum.checksums_gather(tp, 30, 50, 16)
    s_d, h_d = exp_checksum.checksums_slice(tp, 30, 50, 16)
    rows = np.concatenate([pages[0][:30], pages[1][:20]]).astype(np.uint32)
    w = (np.arange(rows.shape[1], dtype=np.uint32) % 251 + 1).astype(np.uint32)
    want_s, want_h = rows.sum(1, dtype=np.uint32), (rows * w).sum(1, dtype=np.uint32)
    for a in (s_g, s_d):
        np.testing.assert_array_equal(a, want_s.astype(np.int64))
    for a in (h_g, h_d):
        np.testing.assert_array_equal(a, want_h.astype(np.int64))
    assert h_g.max() < 2 ** 32
    assert len(exp_checksum.read_audit(tp, 30, 50, 16)) == 0


# ---------------------------------------------------------------------------
# exp_paged_audit (176,256 rows, the JAX tool's N)
# ---------------------------------------------------------------------------

N_AUDIT = 176_256
AUDIT_PAGE_ROWS = 88_128


def _lines(out: str) -> list:
    """The audit's lines without the elapsed-time prefix."""
    return [ln.split("] ", 1)[1] if ln.startswith("[") else ln for ln in out.splitlines()]


def test_exp_paged_audit_matches_jax(monkeypatch, capsys):
    pages, labels = synthetic(N_AUDIT, TINY_FRAME, AUDIT_PAGE_ROWS, seed=6)
    patch(monkeypatch, {N_AUDIT: (pages, AUDIT_PAGE_ROWS, TINY_FRAME, labels)},
          [exp_paged_audit])
    # JAX's gather through its plain reference, XLA's clamped table[idx]
    # (tests/test_pallas.py holds the kernel to it): interpret mode takes 7 s
    # a 4,096-row batch here.
    monkeypatch.setattr(j_gather, "gather_rows", lambda table, idx, interpret=None: table.reshape(
        table.shape[0], -1)[jnp.clip(idx, 0, table.shape[0] - 1)])
    runpy.run_path(os.path.join(REPO, "tools", "exp_paged_audit.py"))
    want = _lines(capsys.readouterr().out)
    got = exp_paged_audit.main(["--device", "cpu"])
    out = _lines(capsys.readouterr().out)
    assert got["exactness_mismatches"] == 0 and got["pages"] == 2
    assert "EXACTNESS: 0 mismatching checksums over 176256 rows " \
           "(paged gather vs dynamic_slice)" in want
    assert [ln for ln in out if ln.startswith("EXACTNESS")] == \
        [ln for ln in want if ln.startswith("EXACTNESS")]
    # The oracle: the same counts, shares by 20k rows, page and env.
    pick = lambda lines: [ln for ln in lines if ln.startswith(("  rows", "  page", "  by env"))]
    assert pick(out) == pick(want) and len(pick(want)) == 9 + 2 + 1
    jo = next(ln for ln in want if ln.startswith("ORACLE"))
    to = next(ln for ln in out if ln.startswith("ORACLE"))
    assert jo.split(",")[0] == to.split(",")[0]  # the mismatch count and share
    med = lambda ln: [float(x) for x in re.findall(r"med_[nd]=([0-9.]+)", ln)]
    np.testing.assert_allclose(np.array(med(to)) * 96 / 128, med(jo), atol=0.06)
    o = got["oracle"]
    assert o["rows"] == N_AUDIT and 0 < o["mismatches"] < N_AUDIT // 10
    assert o["med_n"] < o["med_d"]


# ---------------------------------------------------------------------------
# The arm tools
# ---------------------------------------------------------------------------

ARM_ROWS = 480


@pytest.fixture(scope="module")
def arm_collection():
    pages, labels = synthetic(ARM_ROWS, FRAME, ARM_ROWS, seed=7)
    return {ARM_ROWS: (pages, ARM_ROWS, FRAME, labels)}


def _recorder(calls: list):
    def train(ds, cfg, *args, **kwargs):
        assert not args
        calls.append((ds, cfg, kwargs))
        h = [{"val_loss": 0.5, "steer_err_LEFT": 0.25, "steer_err_RIGHT": 0.125}]
        return {"history": h, "best_val_loss": 0.5}
    return train


ARM_TOOLS = {
    "exp_seed_arms": (exp_seed_arms, ["--seeds", "43", "137"]),
    "exp_row_region": (exp_row_region, ["--train-rows", "200"]),
    "exp_size_bisect": (exp_size_bisect, ["--sizes", "100", "250"]),
    "exp_stage2": (exp_stage2, ["--init", "some/run/ckpt", "--ckpt-dir", "some/dir"]),
    "exp_noeval_train": (exp_noeval_train, ["--eval-every", "3"]),
}


def _cfg_dict(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=list))


@pytest.mark.parametrize("name", list(ARM_TOOLS))
def test_arm_tool_trains_the_jax_tools_arms(name, arm_collection, monkeypatch, tmp_path):
    mod, flags = ARM_TOOLS[name]
    argv = ["--frames", str(ARM_ROWS), "--epochs", "2", *flags]
    jcalls, tcalls = [], []
    patch(monkeypatch, arm_collection, [arms])
    monkeypatch.setattr(j_loop, "train", _recorder(jcalls))
    monkeypatch.setattr(arms, "train", _recorder(tcalls))
    monkeypatch.chdir(tmp_path)  # the tools write under runs/
    os.makedirs("runs")
    jax_module(name).main(argv + ["--out", "runs/j.json"])
    got = mod.main(argv + ["--out", "runs/t.json", "--device", "cpu"])
    with open("runs/t.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    with open("runs/j.json") as f:
        want = json.load(f)
    strip = lambda d: {k: v for k, v in d.items() if k != "wall_s"} if isinstance(d, dict) else d
    if "history" in want:  # one run
        assert strip(got) == strip(want)
    else:
        assert {k: strip(v) for k, v in got.items()} == {k: strip(v) for k, v in want.items()}
    assert len(jcalls) == len(tcalls) >= 1
    for (jds, jcfg, jkw), (tds, tcfg, tkw) in zip(jcalls, tcalls):
        for f in ("speed_norm", "command", "controls"):
            np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
        assert tds.images is None and jds.images is None
        assert _cfg_dict(tcfg) == _cfg_dict(jcfg) and tcfg.training.epochs == 2
        assert str(tkw.pop("device")) == "cpu"
        jt, tt = jkw.pop("resident"), tkw.pop("resident")
        assert tt["page_rows"] == jt["page_rows"] == ARM_ROWS
        assert set(tkw) == set(jkw), (tkw, jkw)
        for k, v in jkw.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(tkw[k], v)
            else:
                assert tkw[k] == v, k


def test_seed_arms_real_arm_in_each_package(arm_collection, monkeypatch, tmp_path):
    """One stream seed, one epoch, a (1, 1, 1, 1) CILRS at batch 40, through
    each package's own resident train loop."""
    patch(monkeypatch, arm_collection, [arms])
    tiny = {"model": {"dropout": 0.0, "image_height": FRAME[0], "image_width": FRAME[1],
                      "stage_sizes": (1, 1, 1, 1)}, "training": {"batch_size": 40}}
    jcfg = j_config.TrainConfig(model=j_config.ModelConfig(**tiny["model"]),
                                training=j_config.TrainingConfig(**tiny["training"]))
    tcfg = t_config.TrainConfig(model=t_config.ModelConfig(**tiny["model"]),
                                training=t_config.TrainingConfig(**tiny["training"]))
    monkeypatch.setattr(j_config, "load_train_config", lambda *a: jcfg)
    monkeypatch.setattr(arms, "load_train_config", lambda *a: tcfg)
    # One device, as the JAX tool runs on one chip (the conftest makes eight).
    monkeypatch.setattr(j_loop, "train", functools.partial(j_loop.train, mesh=make_mesh(1)))
    argv = ["--frames", str(ARM_ROWS), "--epochs", "1", "--seeds", "43"]
    jax_module("exp_seed_arms").main(argv + ["--out", str(tmp_path / "j.json")])
    got = exp_seed_arms.main(argv + ["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    assert list(got) == list(want) == ["stream_seed_43"]
    g, w = got["stream_seed_43"], want["stream_seed_43"]
    assert list(g) == list(w) == ["best_val", "left_err_last", "right_err_last", "history",
                                  "wall_s"]
    assert len(g["history"]) == len(w["history"]) == 1
    assert set(w["history"][0]) <= set(g["history"][0])
    assert all(np.isfinite(v) for v in (g["best_val"], g["left_err_last"], g["right_err_last"]))


def test_arm_tools_refuse_cuda_without_a_gpu():
    for mod, _ in ARM_TOOLS.values():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            mod.main(["--frames", "10"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        exp_checksum.main([])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        exp_paged_audit.main([])
