"""The port's 200k-table experiments (``cilrs_tpu_torch/tools``:
``exp_table_integrity``, ``exp_200k_bisect``, ``exp_tail_poison``,
``exp_band_arms``, ``exp_big_table_control``) against the repo's JAX tools
(``tools/*.py``) on the same inputs.

As in tests/test_torch_audits.py (whose synthetic collection and patches
this file uses), both packages' ``collect_resident`` and ``build_map`` hand
over one synthetic collection made with numpy from a seed, the JAX entry
helpers are no-ops, and JAX's gather runs through its plain reference
(XLA's clamped ``table[idx]``; interpret mode takes seconds a batch here).

 - ``exp_table_integrity`` at the JAX default of 200,000 rows (4x8x3 frames,
   one page): the same mismatches, 10k-row bins and threshold; the 2^33 line
   in each package's own row bytes;
 - ``label_analysis`` dict for dict, ``pixel_band_stats`` equal, and the
   contact sheet: the port's PNG decodes (zlib) to the 16 frames the JAX
   figure shows, with its titles printed;
 - each arm tool's ``train()`` arguments exact (labels, mask, cap,
   truncation, epochs, checkpoint directory), ``train`` recording them on
   both sides, and each report (the rows scored, the weather) equal;
 - every new tool refuses ``cuda`` without a GPU, and importing any of the
   ten new modules leaves ``os.environ`` as it was.
"""

import dataclasses
import importlib
import json
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.config as j_config  # noqa: E402
import cilrs_tpu.data.dataset as j_dataset  # noqa: E402
import cilrs_tpu.evaluation.report as j_report  # noqa: E402
import cilrs_tpu.ops.gather as j_gather  # noqa: E402
import cilrs_tpu.train.checkpoint as j_ckpt  # noqa: E402
import cilrs_tpu.train.loop as j_loop  # noqa: E402
from cilrs_tpu_torch import config as t_config  # noqa: E402
from cilrs_tpu_torch.data.dataset import stratified_split  # noqa: E402
from cilrs_tpu_torch.data.resident import unwrap_monolithic  # noqa: E402
from cilrs_tpu_torch.tools import (arms, exp_200k_bisect, exp_band_arms,  # noqa: E402
                                   exp_big_table_control, exp_table_integrity, exp_tail_poison)
from test_torch_audits import TINY_FRAME, jax_module, patch, synthetic, tables  # noqa: E402

BIG = 200_000
SWITCHES = ("CILRS_TPU_ALLOW_BIG_TABLE", "CILRS_TPU_CONTINUOUS_COLLECT")
NEW_TOOLS = ("probes", "exp_table_integrity", "exp_200k_bisect", "exp_tail_poison",
             "exp_band_arms", "exp_big_table_control", "exp_train_gather_probe",
             "exp_page2_identity", "exp_eval_page_mutation", "exp_eval_sideeffect",
             "exp_dispatch_divergence")


def plain_jax_gather(mp):
    """JAX's gather through its plain reference, as tests/test_pallas.py
    holds the kernel to it."""
    mp.setattr(j_gather, "gather_rows", lambda table, idx, interpret=None: table.reshape(
        table.shape[0], -1)[jnp.clip(idx, 0, table.shape[0] - 1)])


def clear_switches(mp):
    """The switches absent now and, whatever the test set, after it (the JAX
    tools set them when they are imported)."""
    for name in SWITCHES:
        mp.setenv(name, "0")  # recorded, so that teardown restores the state before
        mp.delenv(name)


@pytest.fixture(autouse=True)
def _restore_switches(monkeypatch):
    """Every test leaves the switches as it found them: loading a JAX tool
    sets its switch."""
    clear_switches(monkeypatch)


@pytest.fixture(scope="module")
def big_collection():
    pages, labels = synthetic(BIG, TINY_FRAME, BIG, seed=11)
    return pages, labels


# ---------------------------------------------------------------------------
# exp_table_integrity, label_analysis, pixel_band_stats, the contact sheet
# ---------------------------------------------------------------------------


def test_exp_table_integrity_matches_jax_at_200k_rows(big_collection, monkeypatch, tmp_path,
                                                      capsys):
    pages, labels = big_collection
    clear_switches(monkeypatch)
    calls = []
    patch(monkeypatch, {BIG: (pages, BIG, TINY_FRAME, labels)}, [exp_table_integrity], calls)
    plain_jax_gather(monkeypatch)
    jax_module("exp_table_integrity").main(["--out", str(tmp_path / "j.json")])
    clear_switches(monkeypatch)
    got = exp_table_integrity.main(["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    assert not any(name in os.environ for name in SWITCHES)  # restored after the run
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == got
    assert [c[-1] for c in calls] == ["1", "1"]  # both collected with the big-table switch
    for k in ("frames", "threshold", "total_mismatch", "bins"):
        assert got[k] == want[k], k
    assert 0 < got["total_mismatch"] < BIG // 100 and len(got["bins"]) == 20
    # Each package's own row: 96 B here, JAX's padded to 128 B.
    assert (got["row_bytes"], want["row_bytes"]) == (96, 128)
    assert got["wrap_row"] == 2 ** 33 / 96 and want["wrap_row"] == 2 ** 33 / 128
    out = capsys.readouterr().out
    assert out.count("TOTAL label<->image weather mismatches") == 2


def test_row_means_are_the_frames_byte_means(big_collection):
    """row_means reads every row once, ``batch`` rows a gather, and averages
    the frame's bytes only (the row's padding does not count): float32 sums
    of at most 2^24 are exact, then one rounded division."""
    pages, _ = big_collection
    padded = torch.from_numpy(np.pad(pages[0], ((0, 0), (0, 32)), constant_values=255))
    means = exp_table_integrity.row_means({"images": padded, "image_shape": TINY_FRAME}, BIG,
                                          4096)
    want = pages[0][:BIG].sum(axis=1).astype(np.float32) / np.float32(96)
    np.testing.assert_array_equal(means, want)


def test_label_analysis_matches_jax(big_collection, capsys):
    _, labels = big_collection
    jtool = jax_module("exp_200k_bisect")
    want = jtool.label_analysis(labels)
    got = exp_200k_bisect.label_analysis(labels)
    assert got == want and len(got["bands"]) == 13
    jtool.print_bands(want)
    exp_200k_bisect.print_bands(got)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:len(lines) // 2] == lines[len(lines) // 2:]


def test_pixel_band_stats_match_jax(big_collection, monkeypatch):
    pages, labels = big_collection
    jt, tt = tables(pages, BIG, TINY_FRAME, labels)
    plain_jax_gather(monkeypatch)
    want = jax_module("exp_tail_poison").pixel_band_stats(
        {**jt, "images": jt["images"][0]}, labels)
    got = exp_tail_poison.pixel_band_stats(unwrap_monolithic(tt), labels)
    assert got == want and [r["tick_lo"] for r in got] == [0, 3000, 6000, 9000, 12000]


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG with unfiltered rows (what write_png writes)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], 1 + shape[1] * 3)
    assert not raw[:, 0].any()  # filter 0 on every row
    return raw[:, 1:].reshape(shape[0], shape[1], 3)


def test_contact_sheet_decodes_to_the_jax_figures_frames(big_collection, monkeypatch, tmp_path,
                                                         capsys):
    import matplotlib.axes

    pages, labels = big_collection
    jt, tt = tables(pages, BIG, TINY_FRAME, labels)
    plain_jax_gather(monkeypatch)
    shown, titles = [], []
    imshow, set_title = matplotlib.axes.Axes.imshow, matplotlib.axes.Axes.set_title
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", lambda ax, x, *a, **k: (
        shown.append(np.array(x)), imshow(ax, x, *a, **k))[1])
    monkeypatch.setattr(matplotlib.axes.Axes, "set_title",
                        lambda ax, t, *a, **k: (titles.append(t), set_title(ax, t, *a, **k))[1])
    jax_module("exp_tail_poison").turn_contact_sheet({**jt, "images": jt["images"][0]}, labels,
                                                     str(tmp_path / "j.png"))
    capsys.readouterr()
    rows = exp_tail_poison.turn_contact_sheet(unwrap_monolithic(tt), labels,
                                              str(tmp_path / "t.png"))
    out = capsys.readouterr().out
    assert len(rows) == len(shown) == 16
    sheet = read_png(str(tmp_path / "t.png"))
    h, w, _ = TINY_FRAME
    g = exp_tail_poison.SHEET_GAP
    assert sheet.shape == (2 * h + g, 8 * w + 7 * g, 3)
    for i, frame in enumerate(shown):
        y, x = (i // 8) * (h + g), (i % 8) * (w + g)
        np.testing.assert_array_equal(sheet[y:y + h, x:x + w], frame)
        np.testing.assert_array_equal(frame.reshape(-1), pages[0][rows[i]])
        assert titles[i].replace("\n", " ") in out
    assert not sheet[h:h + g].any()  # the gap between the rows


# ---------------------------------------------------------------------------
# The arm tools' train() arguments and reports
# ---------------------------------------------------------------------------

ARM_ROWS = 600  # one page, as the big-table switch lays out a collection
BAND_ROWS = 640  # two pages of 320 rows: exp_band_arms' page-aligned arms
FRESH = arms.FRESH_FRAMES


@pytest.fixture(scope="module")
def arm_collections():
    pages, labels = synthetic(ARM_ROWS, TINY_FRAME, ARM_ROWS, seed=12)
    two, two_labels = synthetic(BAND_ROWS, TINY_FRAME, BAND_ROWS // 2, seed=14)
    fresh, flabels = synthetic(FRESH, TINY_FRAME, FRESH, seed=13)
    return {ARM_ROWS: (pages, ARM_ROWS, TINY_FRAME, labels),
            BAND_ROWS: (two, BAND_ROWS // 2, TINY_FRAME, two_labels),
            FRESH: (fresh, FRESH, TINY_FRAME, flabels)}


def _train_recorder(calls: list, split):
    def train(ds, cfg, *args, **kwargs):
        assert not args
        calls.append((ds, cfg, kwargs, [os.environ.get(n) for n in SWITCHES]))
        _, val = split(ds, cfg.training.val_fraction, cfg.training.seed)
        h = [{"val_loss": 0.5, "steer_err_LEFT": 0.25, "steer_err_RIGHT": 0.125}]
        return {"history": h, "best_val_loss": 0.5, "val_table": kwargs["resident"],
                "val_rows": np.asarray(val)}
    return train


def _predictions_recorder(calls: list):
    def collect(model_or_state, table, labels, idx, batch, cfg):
        idx = np.asarray(idx)
        calls.append((idx, batch))
        pred = np.stack([np.cos(idx), np.sin(idx), 0.5 * np.ones(len(idx)),
                         0.01 * (idx % 7)], axis=1).astype(np.float32)
        true = np.concatenate([labels["controls"][idx], labels["speed"][idx][:, None]], axis=1)
        return pred, true, labels["command"][idx]
    return collect


TINY_MODEL = dict(dropout=0.0, image_height=8, image_width=16, stage_sizes=(1, 1, 1, 1))
J_TINY = j_config.TrainConfig(model=j_config.ModelConfig(**TINY_MODEL))
T_TINY = t_config.TrainConfig(model=t_config.ModelConfig(**TINY_MODEL))

EXPERIMENT_ARMS = {
    "exp_200k_bisect": (exp_200k_bisect, ["--frames", str(ARM_ROWS), "--subset", "300"]),
    "exp_200k_bisect_one_arm": (exp_200k_bisect, ["--frames", str(ARM_ROWS), "--arms", "full"]),
    "exp_tail_poison": (exp_tail_poison, ["--frames", str(ARM_ROWS), "--prefix-frames", "400"]),
    "exp_big_table_control": (exp_big_table_control, ["--frames", str(ARM_ROWS),
                                                      "--truncate", "450"]),
    "exp_band_arms": (exp_band_arms, ["--frames", str(BAND_ROWS), "--bands", "100:300",
                                      "300:550"]),
    "exp_band_arms_by_page": (exp_band_arms, ["--frames", str(BAND_ROWS)]),
}


def _cfg_dict(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=list))


def _reports(d) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            if f.startswith("evaluation_report") or f in ("label_analysis.json",
                                                          "pixel_band_stats.json"):
                with open(os.path.join(root, f)) as fh:
                    out[f] = json.load(fh)
    return out


@pytest.mark.parametrize("case", list(EXPERIMENT_ARMS))
def test_experiment_trains_the_jax_tools_arms(case, arm_collections, monkeypatch, tmp_path):
    mod, flags = EXPERIMENT_ARMS[case]
    name = case.replace("_one_arm", "").replace("_by_page", "")
    clear_switches(monkeypatch)
    calls = []
    patch(monkeypatch, arm_collections,
          [m for m in (mod, arms) if hasattr(m, "collect_resident")], calls)
    plain_jax_gather(monkeypatch)
    jcalls, tcalls, jpred, tpred = [], [], [], []
    monkeypatch.setattr(j_loop, "train", _train_recorder(jcalls, j_dataset.stratified_split))
    monkeypatch.setattr(j_ckpt, "restore_best_params", lambda d, state: state)
    monkeypatch.setattr(j_report, "collect_predictions_resident", _predictions_recorder(jpred))
    monkeypatch.setattr(j_config, "load_train_config", lambda *a: J_TINY)
    for m in {mod, arms}:
        if hasattr(m, "train"):
            monkeypatch.setattr(m, "train", _train_recorder(tcalls, stratified_split))
        if hasattr(m, "load_train_config"):
            monkeypatch.setattr(m, "load_train_config", lambda *a: T_TINY)
    monkeypatch.setattr(arms, "restore_best_params", lambda d, state: state)
    monkeypatch.setattr(arms, "collect_predictions_resident", _predictions_recorder(tpred))
    monkeypatch.chdir(tmp_path)  # band arms write runs/band_arms.json
    os.makedirs("runs")
    epochs = ["--epochs", "2"]
    extra = (["--out", "runs/{}.json"] if name == "exp_band_arms" else ["--workdir", "{}"])
    jax_module(name).main(flags + epochs + [a.format("j") for a in extra])
    clear_switches(monkeypatch)
    got = mod.main(flags + epochs + [a.format("t") for a in extra] + ["--device", "cpu"])
    assert not any(n in os.environ for n in SWITCHES)  # restored after the run
    # The same collections, under the same switches.
    assert [c[1:] for c in calls if c[0] == 1] == [c[1:] for c in calls if c[0] == 0]
    assert all(c[4] == (None if name == "exp_band_arms" else "1") for c in calls)
    assert len(jcalls) == len(tcalls) >= 1
    for (jds, jcfg, jkw, jenv), (tds, tcfg, tkw, tenv) in zip(jcalls, tcalls):
        # Both trained under the switches the JAX tool sets.
        assert tenv == jenv == (["1", None] if name != "exp_band_arms" else [None, "1"])
        for f in ("speed_norm", "command", "controls"):
            np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
        assert tds.images is None and jds.images is None
        assert _cfg_dict(tcfg) == _cfg_dict(jcfg) and tcfg.training.epochs == 2
        assert str(tkw.pop("device")) == "cpu"
        jt, tt = jkw.pop("resident"), tkw.pop("resident")
        assert tt["page_rows"] == jt["page_rows"] == (
            BAND_ROWS // 2 if name == "exp_band_arms" else ARM_ROWS)
        if "ckpt_dir" in jkw:
            assert os.path.relpath(tkw.pop("ckpt_dir"), "t") == \
                os.path.relpath(jkw.pop("ckpt_dir"), "j")
        assert set(tkw) == set(jkw), (tkw, jkw)
        for k, v in jkw.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(tkw[k], v)
            else:
                assert tkw[k] == v, k
    # The rows each report scored, and the reports.
    assert len(jpred) == len(tpred)
    for (ji, jb), (ti, tb) in zip(jpred, tpred):
        np.testing.assert_array_equal(ti, ji)
        assert jb == tb
    if name == "exp_band_arms":
        with open("runs/j.json") as f:
            want = json.load(f)
        strip = lambda d: {k: v for k, v in d.items() if k != "wall_s"}
        assert {k: strip(v) for k, v in got.items()} == {k: strip(v) for k, v in want.items()}
    else:
        assert _reports("t") == _reports("j") and _reports("t")
    if name == "exp_tail_poison":  # early and tail val rows, then the fresh holdout
        assert (tpred[0][0] < 400).all() and (tpred[1][0] >= 400).all()
        assert len(tpred[2][0]) == got["reports"]["fresh"]["num_samples"] == FRESH
    if name == "exp_big_table_control":
        assert len(tcalls[0][0].command) == 450 and len(tpred[0][0]) == FRESH


# ---------------------------------------------------------------------------
# GPU refusal, imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in NEW_TOOLS if n != "probes"])
def test_new_tools_refuse_cuda_without_a_gpu(name):
    mod = importlib.import_module(f"cilrs_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main([])


@pytest.mark.parametrize("name", NEW_TOOLS)
def test_importing_a_new_tool_leaves_the_environment(name):
    before = dict(os.environ)
    importlib.reload(importlib.import_module(f"cilrs_tpu_torch.tools.{name}"))
    assert dict(os.environ) == before
