"""Offline-evaluation slice parity: cilrs_tpu_torch against the JAX package.

Datasets, the split, the resident table and the whole
collect_predictions_resident -> offline_report path, on 32x64 frames and a
(1, 1, 1, 1) trunk, plus the port's own rules: it imports nothing of JAX and
never carries on on the CPU when CUDA was asked for. Tolerances are those of
tests/test_torch_model.py (pred_speed atol 2e-3 / rtol 1e-3; controls atol
1e-3, set by the bf16 rounding of the branch heads).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cilrs_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from cilrs_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from cilrs_tpu.config import TrainingConfig as JTrainingConfig  # noqa: E402
from cilrs_tpu.data import dataset as jds  # noqa: E402
from cilrs_tpu.evaluation import report as jrep  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu.ops.gather import LANE  # noqa: E402
from cilrs_tpu.ops.gather import padded_row_elems as j_padded_row_elems  # noqa: E402
from cilrs_tpu.ops.gather import paged_layout as j_paged_layout  # noqa: E402
from cilrs_tpu.train.state import create_train_state  # noqa: E402
from cilrs_tpu_torch import config as tcfg  # noqa: E402
from cilrs_tpu_torch.data import dataset as tds  # noqa: E402
from cilrs_tpu_torch.data.resident import ship_resident  # noqa: E402
from cilrs_tpu_torch.evaluation import report as trep  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.ops.gather import gather_rows_paged, paged_layout  # noqa: E402
from cilrs_tpu_torch.train.checkpoint import save_checkpoint_pth  # noqa: E402
from cilrs_tpu_torch.train.steps import make_eval_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 64
TINY = dict(stage_sizes=(1, 1, 1, 1))
J_TINY_CFG = JTrainConfig(
    model=JModelConfig(dropout=0.0, image_height=H, image_width=W, **TINY),
    training=JTrainingConfig(batch_size=16, epochs=1))
T_TINY_CFG = tcfg.TrainConfig(
    model=tcfg.ModelConfig(dropout=0.0, image_height=H, image_width=W, **TINY),
    training=tcfg.TrainingConfig(batch_size=16, epochs=1))


def _same_dataset(a, b):
    for f in ("images", "speed_norm", "command", "controls"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n,seed,frac", [(512, 0, 0.15), (1000, 3, 0.15), (97, 42, 0.3)])
def test_stratified_split_bit_identical(n, seed, frac):
    j = jds.make_synthetic_dataset(n, seed=seed, h=4, w=6)
    t = tds.make_synthetic_dataset(n, seed=seed, h=4, w=6)
    _same_dataset(j, t)
    for a, b in zip(jds.stratified_split(j, frac, 42), tds.stratified_split(t, frac, 42)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_sessions_matches_jax(tmp_path):
    """save_session writes what both packages' load_sessions read, the same."""
    ds = tds.make_synthetic_dataset(45, seed=1, h=H, w=W)
    dirs = [str(tmp_path / "s0"), str(tmp_path / "s1")]
    tds.save_session(dirs[0], ds, shard_size=20)
    tds.save_session(dirs[1], tds.make_synthetic_dataset(7, seed=2, h=H, w=W))
    t = tds.load_sessions(dirs, cache=False)
    _same_dataset(t, jds.load_sessions(dirs, cache=False))
    np.testing.assert_array_equal(t.images[:45], ds.images)
    np.testing.assert_array_equal(t.command[:45], ds.command)
    np.testing.assert_allclose(t.speed_norm[:45], ds.speed_norm, atol=1e-6)
    np.testing.assert_allclose(t.controls[:45], ds.controls, atol=1e-6)
    # Second load reads the .cache.npz sidecar the first wrote.
    cached = tds.load_sessions(dirs)
    assert os.path.exists(os.path.join(dirs[0], ".cache.npz"))
    _same_dataset(tds.load_sessions(dirs), cached)
    _same_dataset(cached, jds.load_sessions(dirs))
    with open(os.path.join(dirs[0], "measurements.csv")) as f:
        assert f.readline().strip().split(",") == tds.CSV_HEADER
    assert tds.COMMAND_MAP == jds.COMMAND_MAP


@pytest.mark.parametrize("with_weather", [False, True])
def test_offline_report_identical(with_weather):
    rng = np.random.RandomState(4)
    n = 300
    pred = rng.randn(n, 4).astype(np.float32) * 0.1
    true = pred + rng.randn(n, 4).astype(np.float32) * 0.03
    cmd = rng.randint(0, 3, n).astype(np.int32)  # one command absent
    weather = rng.randint(0, 5, n) if with_weather else None
    assert trep.offline_report(pred, true, cmd, weather) == jrep.offline_report(pred, true, cmd, weather)


def test_ship_resident_layout():
    ds = tds.make_synthetic_dataset(50, seed=5, h=H, w=W)
    idx = np.random.RandomState(6).permutation(50)[:37]
    row = H * W * 3
    table = ship_resident(ds, "cpu", idx=idx, max_page_bytes=16 * row)
    assert table["image_shape"] == (H, W, 3)
    num_pages, page_rows, _ = paged_layout(37, row, 0, 16 * row)
    assert len(table["images"]) == num_pages == 3 and table["page_rows"] == page_rows == 13
    assert [p.shape for p in table["images"]] == [(13, row), (13, row), (11, row)]
    flat = torch.cat(table["images"]).numpy()
    np.testing.assert_array_equal(flat, ds.images[idx].reshape(37, -1))
    np.testing.assert_array_equal(table["speed"].numpy(), ds.speed_norm[idx])
    np.testing.assert_array_equal(table["command"].numpy(), ds.command[idx])
    np.testing.assert_array_equal(table["controls"].numpy(), ds.controls[idx])
    # Rows that are not 16-byte aligned get zero padding.
    odd = tds.make_synthetic_dataset(5, seed=7, h=3, w=5)  # 45 B rows -> 48
    t2 = ship_resident(odd, "cpu")
    assert t2["images"][0].shape == (5, 48) and not t2["images"][0][:, 45:].any()
    got = gather_rows_paged(t2["images"], torch.tensor([4, 0]), t2["page_rows"])
    np.testing.assert_array_equal(got[:, :45].numpy(), odd.images[[4, 0]].reshape(2, -1))


def _jax_table(ds, max_page_bytes):
    """The JAX package's table for ds: _ship-style pre-blocked [n, R, 128]
    pages, tile-padded rows, paged as collect_resident pages them."""
    d = H * W * 3
    d_pad = j_padded_row_elems(d, np.uint8)
    num_pages, page_rows, _ = j_paged_layout(len(ds), d_pad, 0, max_page_bytes)
    pages = []
    for p in range(num_pages):
        rows = np.arange(p * page_rows, min((p + 1) * page_rows, len(ds)))
        blk = np.zeros((len(rows), d_pad // LANE, LANE), np.uint8)
        blk.reshape(len(rows), -1)[:, :d] = ds.images[rows].reshape(len(rows), -1)
        pages.append(jnp.asarray(blk))
    return {"images": tuple(pages), "page_rows": page_rows, "image_shape": (H, W, 3),
            "speed": jnp.asarray(ds.speed_norm), "command": jnp.asarray(ds.command),
            "controls": jnp.asarray(ds.controls)}


def _perturbed(params, rng):
    """Init-scale weights x(1 +- 10%); biases and the speed skip +-0.1."""
    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key in ("bias", "b1", "b2", "b3", "speed_skip_w"):
            return a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        return a * rng.uniform(0.9, 1.1, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def test_collect_predictions_resident_slice_matches_jax():
    """The slice as a whole, on a 2-page table with a padded tail group:
    JAX collect_predictions_resident (Pallas gather in interpret mode, float32
    CILRS) against the port's (plain gather on the CPU), then offline_report."""
    n = 100
    ds = jds.make_synthetic_dataset(n, seed=8, h=H, w=W)
    labels = {"speed": ds.speed_norm, "command": ds.command, "controls": ds.controls}
    idx = np.random.RandomState(9).permutation(n)
    batch = 3  # groups of 25 x 3 = 75 rows, then a 25-row tail padded to 27

    state = create_train_state(J_TINY_CFG, jax.random.PRNGKey(0))
    rng = np.random.RandomState(10)
    params = _perturbed(state.params, rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: rng.uniform(*((-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)),
                                    np.shape(a)).astype(np.float32), state.batch_stats)
    jmodel = JCILRS(dropout=0.0, dtype=jnp.float32, speed_skip=True, **TINY)
    state = state.replace(params=params, batch_stats=stats, apply_fn=jmodel.apply)
    jtable = _jax_table(ds, max_page_bytes=60 * 8192)
    assert len(jtable["images"]) == 2
    jpred, jtrue, jcmd = jrep.collect_predictions_resident(state, jtable, labels, idx, batch, J_TINY_CFG)

    model = CILRS(dropout=0.0, dtype=torch.float32, speed_skip=True, **TINY)
    model.load_state_dict(flax_to_state_dict(params, stats))
    model.eval()
    ttable = ship_resident(ds, "cpu", max_page_bytes=60 * H * W * 3)
    assert len(ttable["images"]) == 2
    tpred, ttrue, tcmd = trep.collect_predictions_resident(model, ttable, labels, idx, batch, T_TINY_CFG)

    assert tpred.shape == jpred.shape == (n, 4) and np.all(np.isfinite(tpred))
    assert np.all(jpred.std(axis=0) > 1e-3)  # every output varies: correlations mean something
    np.testing.assert_array_equal(ttrue, jtrue)
    np.testing.assert_array_equal(tcmd, jcmd)
    np.testing.assert_allclose(tpred[:, 3], jpred[:, 3], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(tpred[:, :3], jpred[:, :3], atol=1e-3, rtol=0)

    want = jrep.offline_report(jpred, jtrue, jcmd, ds.command % 5)
    got = trep.offline_report(tpred, ttrue, tcmd, ds.command % 5)

    def leaves(r, prefix=""):
        for k, v in r.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for k, v in want_leaves.items():
        if k.startswith("steer_accuracy"):  # a fraction of rows: one row may sit on a threshold
            assert abs(got_leaves[k] - v) <= 1.0 / n, k
        else:
            np.testing.assert_allclose(got_leaves[k], v, atol=2e-3, rtol=1e-3, err_msg=k)


def test_report_cli_on_cpu(tmp_path):
    """The CLI end to end at the configured full width (ResNet-34, 88x200):
    sessions -> val split -> resident table -> report JSON, equal to the
    host-batch path's predictions for the same rows."""
    from cilrs_tpu_torch.cli import report as cli

    ds = tds.make_synthetic_dataset(40, seed=11)
    tds.save_session(str(tmp_path / "s"), ds)
    cfg = tcfg.load_train_config()
    torch.manual_seed(0)
    model = CILRS(dropout=cfg.model.dropout, dtype=torch.float32, speed_skip=True)
    with torch.no_grad():
        model.speed_skip_w.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "policy.pth")
    save_checkpoint_pth(ckpt, model, epoch=0, val_loss=float("inf"))
    out = str(tmp_path / "report.json")
    report = cli.main(["--data", str(tmp_path / "s"), "--checkpoint", ckpt, "--out", out,
                       "--batch-size", "4", "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == report
    loaded = tds.load_sessions([str(tmp_path / "s")])
    _, val_idx = tds.stratified_split(loaded, cfg.training.val_fraction, cfg.training.seed)
    assert report["num_samples"] == len(val_idx) > 0
    assert set(report) == {"num_samples", "steer", "throttle", "brake", "speed", "per_command",
                           "steer_percentiles", "steer_accuracy"}
    # Batch 1: the host-batch path drops a partial tail batch, so every row is kept.
    pred, true, cmd = trep.collect_predictions(model.eval(), loaded, val_idx, 1, make_eval_step(cfg))
    assert len(pred) == len(val_idx)
    ref = trep.offline_report(pred, true, cmd)
    for name in ("steer", "throttle", "brake", "speed"):
        for k, v in ref[name].items():
            np.testing.assert_allclose(report[name][k], v, atol=1e-4, rtol=1e-4, err_msg=f"{name}.{k}")


_BLOCKED_IMPORT = """
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "cilrs_tpu"):
    sys.modules[name] = None
import cilrs_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cilrs_tpu_torch.__path__, "cilrs_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(mods))
"""


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax,
    optax, orbax and cilrs_tpu blocked."""
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


@pytest.mark.parametrize("entry", ["require_cuda", "ship_resident", "load_policy", "cli"])
def test_no_cpu_fallback(entry, tmp_path, monkeypatch):
    """Entry points called with the default device raise when there is no GPU."""
    from cilrs_tpu_torch.cli import report as cli
    from cilrs_tpu_torch.cli.common import require_cuda
    from cilrs_tpu_torch.train.checkpoint import load_policy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = tds.make_synthetic_dataset(4, seed=0, h=4, w=4)
    ckpt = str(tmp_path / "m.pth")
    save_checkpoint_pth(ckpt, CILRS(**TINY), 0, 0.0)
    tds.save_session(str(tmp_path / "s"), ds)
    call = {
        "require_cuda": lambda: require_cuda(),
        "ship_resident": lambda: ship_resident(ds),
        "load_policy": lambda: load_policy(ckpt),
        "cli": lambda: cli.main(["--data", str(tmp_path / "s"), "--checkpoint", ckpt,
                                 "--out", str(tmp_path / "r.json")]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        call()
    assert not os.path.exists(tmp_path / "r.json")
