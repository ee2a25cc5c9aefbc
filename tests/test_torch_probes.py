"""The port's train/eval-group probes (``cilrs_tpu_torch/tools``:
``exp_train_gather_probe``, ``exp_page2_identity``, ``exp_eval_page_mutation``,
``exp_eval_sideeffect``, ``exp_dispatch_divergence``, and what they share in
``probes``) against the repo's JAX tools (``tools/*.py``) on the same inputs.

As in tests/test_torch_audits.py (whose synthetic collection and patches
this file uses), both packages' ``collect_resident`` and ``build_map`` hand
over synthetic collections made with numpy from a seed (8x16x3 frames), the
JAX entry helpers are no-ops, and JAX's gather runs through its plain
reference. Both packages train a (1, 1, 1, 1) CILRS with dropout 0 and the
augmentation patched to the identity (tests/test_torch_train.py), the JAX
model in float32, from the same weights: every port state is built with the
JAX state's initial weights (``models/convert.py:flax_to_state_dict``).

 - the uint32 wrap arithmetic against numpy's; each checksum, the page hash,
   the params fingerprint and the md5 fingerprint against the JAX tools'
   expressions on the same inputs, exactly;
 - each tool's main against the JAX tool's: the verdicts equal (no
   mismatching checksum, A == B == C, no page or params mutation, the safe
   eval stable, the crossing eval deterministic, equal divergence
   checksums), the page hashes and the params fingerprint equal exactly; the
   first step's loss of each run (the same weights and batch in both
   packages) within tests/test_torch_train.py's LOSS_TOL of JAX's. Later
   steps are not compared across packages: at batch 8 on 8x16 frames the
   BatchNorm statistics of the last stages are taken over 8 values a
   channel, and float32 rounding differences between the packages grow
   from 2e-4 of the loss at step 1 to 1% by step 7 and 15% by step 50
   (measured), while within the port the runs are equal bit for bit;
 - ``exp_eval_sideeffect`` on a table smaller than its 150,000 safe rows
   (both packages clamp the rows past its end).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cilrs_tpu.config as j_config  # noqa: E402
import cilrs_tpu.train.state as j_state  # noqa: E402
import cilrs_tpu.train.steps as j_steps  # noqa: E402
from cilrs_tpu.models.cilrs import CILRS as JCILRS  # noqa: E402
from cilrs_tpu_torch import config as t_config  # noqa: E402
from cilrs_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from cilrs_tpu_torch.models.cilrs import CILRS  # noqa: E402
from cilrs_tpu_torch.data import resident as t_resident  # noqa: E402
from cilrs_tpu_torch.train import loop as t_loop  # noqa: E402
from cilrs_tpu_torch.train import state as t_state  # noqa: E402
from cilrs_tpu_torch.train import steps as t_steps  # noqa: E402
from cilrs_tpu_torch.tools import (exp_dispatch_divergence, exp_eval_page_mutation,  # noqa: E402
                                   exp_eval_sideeffect, exp_page2_identity,
                                   exp_train_gather_probe, probes)
from test_torch_audits import jax_module, patch, synthetic, tables  # noqa: E402
from test_torch_experiments import clear_switches, plain_jax_gather  # noqa: E402

FRAME = (8, 16, 3)
TINY = dict(dropout=0.0, image_height=FRAME[0], image_width=FRAME[1], stage_sizes=(1, 1, 1, 1))
J_CFG = j_config.TrainConfig(model=j_config.ModelConfig(**TINY),
                             training=j_config.TrainingConfig(batch_size=8))
T_CFG = t_config.TrainConfig(model=t_config.ModelConfig(**TINY),
                             training=t_config.TrainingConfig(batch_size=8))
LOOP_TOL = dict(rtol=5e-3, atol=0)  # tests/test_torch_train.py's
LOSS_TOL = dict(atol=1e-3, rtol=0)
J_CREATE, T_CREATE = j_state.create_train_state, t_state.create_train_state


@pytest.fixture(autouse=True)
def _restore_switches(monkeypatch):
    """Every test leaves the switches as it found them: loading a JAX tool
    sets its switch."""
    clear_switches(monkeypatch)


@pytest.fixture(scope="module")
def collections():
    """{frames: collection}: 600 rows a prefix of 1,200 (one page each), 900
    one page, 1,280 and 2,800 over two pages."""
    big_pages, big_labels = synthetic(1200, FRAME, 1200, seed=21)
    d = big_pages[0].shape[1]
    small = [np.concatenate([big_pages[0][:600], np.zeros((29, d), np.uint8)])]
    out = {1200: (big_pages, 1200, FRAME, big_labels),
           600: (small, 600, FRAME, {k: v[:600] for k, v in big_labels.items()})}
    for n, page_rows, seed in ((900, 900, 22), (1280, 640, 23), (2800, 1400, 24)):
        pages, labels = synthetic(n, FRAME, page_rows, seed)
        out[n] = (pages, page_rows, FRAME, labels)
    return out


@pytest.fixture
def patched(collections, monkeypatch, tmp_path):
    """Both packages on the synthetic collections, the tiny configs, the
    identity augmentation, JAX's float32 model; each port state starts from
    the JAX state's weights. Runs in ``tmp_path``."""
    clear_switches(monkeypatch)
    port = [exp_train_gather_probe, exp_page2_identity, exp_eval_page_mutation,
            exp_eval_sideeffect, exp_dispatch_divergence]
    patch(monkeypatch, collections, port)
    plain_jax_gather(monkeypatch)
    monkeypatch.setattr(j_config, "load_train_config", lambda *a: J_CFG)
    for m in port:
        monkeypatch.setattr(m, "load_train_config", lambda *a: T_CFG)
    monkeypatch.setattr(j_steps, "augment_batch", lambda key, x: x)
    monkeypatch.setattr(t_steps, "augment_batch", lambda gen, x: x)
    jmodel = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=TINY["stage_sizes"])
    inits = {}

    def j_create(cfg, rng, steps_per_epoch=1000, **kw):
        return J_CREATE(cfg, rng, steps_per_epoch, **kw).replace(apply_fn=jmodel.apply)

    def t_create(cfg, seed, steps_per_epoch=1000, schedule="step", total_steps=None,
                 device="cuda"):
        st = T_CREATE(cfg, seed, steps_per_epoch, schedule, total_steps, device=device)
        if seed not in inits:
            js = J_CREATE(J_CFG, jax.random.PRNGKey(seed), steps_per_epoch)
            inits[seed] = flax_to_state_dict(jax.device_get(js.params),
                                             jax.device_get(js.batch_stats))
        st.model.load_state_dict(inits[seed])
        return st

    monkeypatch.setattr(j_state, "create_train_state", j_create)
    for m in (probes, exp_eval_sideeffect, exp_dispatch_divergence):
        monkeypatch.setattr(m, "create_train_state", t_create)
    monkeypatch.chdir(tmp_path)
    return collections


# ---------------------------------------------------------------------------
# uint32 arithmetic and the checksums
# ---------------------------------------------------------------------------


def test_mul32_is_uint32_multiplication():
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.randint(0, 2 ** 32, 10_000, dtype=np.uint64),
                        np.array([0, 1, 2 ** 32 - 1, 2 ** 31, 65535, 65536], np.uint64)])
    b = np.concatenate([rng.randint(0, 2 ** 32, 10_000, dtype=np.uint64),
                        np.array([2 ** 32 - 1, 2 ** 32 - 1, 2 ** 32 - 1, 2, 65537, 65535],
                                 np.uint64)])
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)  # wraps mod 2^32
    got = probes.mul32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (probes.MIX, probes.PAGE_MIX1, probes.PAGE_MIX2):
        np.testing.assert_array_equal(
            probes.mul32(torch.from_numpy(a.astype(np.int64)), k).numpy(),
            (a.astype(np.uint32) * np.uint32(k)).astype(np.int64))


def _batch(rng, b=120):
    return {"images": rng.randint(0, 256, (b, 88, 200, 3)).astype(np.uint8),
            "speed": rng.uniform(-0.5, 1, b).astype(np.float32),
            "command": rng.randint(0, 4, b).astype(np.int32),
            "controls": rng.uniform(-1, 1, (b, 3)).astype(np.float32)}


def _jax_cksum(batch):
    """exp_train_gather_probe.py's _cksum (its expression, verbatim)."""
    MIX = 2654435761
    img = batch["images"].astype(jnp.uint32)
    k = (jnp.arange(img.size, dtype=jnp.uint32) * jnp.uint32(MIX)).reshape(img.shape)
    ck_i = jnp.sum(img * k, dtype=jnp.uint32)
    lab = jnp.concatenate([
        batch["speed"].reshape(-1), batch["command"].astype(jnp.float32),
        batch["controls"].reshape(-1)])
    ck_l = jnp.sum(jax.lax.bitcast_convert_type(lab, jnp.uint32)
                   * jnp.uint32(MIX), dtype=jnp.uint32)
    return ck_i, ck_l


def _jax_page_fp(pg):
    """exp_eval_page_mutation.py's page_fp (verbatim)."""
    MIX1, MIX2 = np.uint32(2654435761), np.uint32(40503)
    s, r, lane = pg.shape
    d = r * lane
    h2 = (jnp.arange(d, dtype=jnp.uint32) * MIX2 + 1).reshape(r, lane)
    row = jnp.sum(pg.astype(jnp.uint32) * h2[None], axis=(1, 2), dtype=jnp.uint32)
    h1 = jnp.arange(s, dtype=jnp.uint32) * MIX1 + 1
    return jnp.sum(row * h1, dtype=jnp.uint32)


def test_batch_checksums_equal_the_jax_probes():
    """The image and label checksums of full-size batches (6.3M bytes a
    batch, so the byte weights wrap many times) equal exp_train_gather_probe's,
    on the card's layout and on the host labels; one byte changed moves the
    image checksum."""
    rng = np.random.RandomState(1)
    batch = _batch(rng)
    want_i, want_l = (int(x) for x in jax.jit(_jax_cksum)({k: jnp.asarray(v)
                                                          for k, v in batch.items()}))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert int(probes.image_checksum(tb["images"])) == want_i
    assert int(probes.label_checksum(tb)) == want_l
    rows = np.arange(120)
    assert probes.host_label_checksum(batch, rows) == want_l
    tb["images"][7, 3, 5, 1] ^= 1
    assert int(probes.image_checksum(tb["images"])) != want_i


def test_page_hash_equals_the_jax_probes():
    """The factored page hash of a page with slack rows: the port's [S, 96]
    rows against the JAX tool's hash of the same bytes in [S, 1, 128] lanes
    (zero padded); rows past 2^16 make the row weights wrap."""
    pages, _ = synthetic(70_000, (4, 8, 3), 70_000, seed=2)
    page = pages[0]
    want = int(jax.jit(_jax_page_fp)(jnp.asarray(np.pad(page, ((0, 0), (0, 32)))
                                                 .reshape(-1, 1, 128))))
    assert probes.page_hash(torch.from_numpy(page)) == want
    page[69_999, 5] ^= 3
    assert probes.page_hash(torch.from_numpy(page)) != want


def test_weighted_checksums_equal_the_jax_probes():
    """exp_dispatch_divergence's per-step weighted checksums of a [3, 120]
    group of full-size frames (each sum wraps mod 2^32)."""
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (3, 120, 88, 200, 3)).astype(np.uint8)
    D = 88 * 200 * 3

    def jax_chk(group):
        w = (jnp.arange(D, dtype=jnp.uint32) % 251 + 1).astype(jnp.uint32)
        imgs_u8 = (group * 1.0).astype(jnp.uint32)
        return (imgs_u8.reshape(3, -1) * jnp.tile(w, 120)).sum(axis=1)

    want = np.asarray(jax.jit(jax_chk)(jnp.asarray(imgs))).astype(np.int64)
    got = probes.weighted_checksums(torch.from_numpy(imgs.reshape(360, 88, 200, 3)), 3)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0 and (imgs.astype(np.int64).sum() * 251 > 2 ** 32)


def test_fingerprints_equal_the_jax_probes():
    """exp_eval_sideeffect's int32-sum fingerprint of a JAX init carried into
    the port's model (params and BatchNorm statistics, not
    num_batches_tracked), and exp_page2_identity's md5 on the same tensors."""
    jm = JCILRS(dropout=0.0, dtype=jnp.float32, stage_sizes=(1, 2, 1, 1))
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 8, 16, 3)), jnp.zeros((1,)),
                                       jnp.zeros((1,), jnp.int32), train=False))
    v = jax.device_get(init(jax.random.PRNGKey(5)))
    tot = 0
    for leaf in jax.tree.leaves({"p": v["params"], "b": v["batch_stats"]}):
        tot = (tot + int(np.asarray(leaf).view(np.int32).astype(np.int64).sum())) % (1 << 61)
    model = CILRS(dropout=0.0, stage_sizes=(1, 2, 1, 1))
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    assert probes.params_fingerprint(model) == tot
    model.speed_skip_w.data[0] += 1e-3
    assert probes.params_fingerprint(model) != tot
    leaves = [np.array(x) for x in jax.tree.leaves(v["params"])][:6]
    assert probes.md5_fingerprint([torch.from_numpy(x) for x in leaves]) == \
        jax_module("exp_page2_identity").fingerprint(leaves)


# ---------------------------------------------------------------------------
# The probes against the JAX tools
# ---------------------------------------------------------------------------


def test_exp_train_gather_probe_matches_jax(patched):
    argv = ["--frames", "1280", "--groups", "1"]
    jax_module("exp_train_gather_probe").main(argv + ["--out", "j.json"])
    got = exp_train_gather_probe.main(argv + ["--out", "t.json", "--device", "cpu"])
    with open("j.json") as f:
        want = json.load(f)
    assert want["mismatch_count"] == got["mismatch_count"] == 0
    for k in ("frames", "page_rows", "groups_probed", "batches_probed",
              "turn_fraction_per_group"):
        assert got[k] == want[k], k
    assert (got["page_rows"], got["groups_probed"], got["batches_probed"]) == (640, 1, 25)
    np.testing.assert_allclose(got["first_group_losses"][0], want["first_group_losses"][0],
                               **LOSS_TOL)


def test_train_gather_probe_catches_a_corrupt_read(patched, monkeypatch):
    """A gather that reads one byte wrong inside the training loop's train
    group only (the reference reads are one batch a launch, through
    ``data.resident.gather_group`` itself) is caught, batch by batch."""
    real = t_loop.gather_group

    def corrupt(table, idxs):
        out = real(table, idxs)
        out["images"][130, 0, 0, 0] ^= 1  # batch 16 of the group
        return out

    monkeypatch.setattr(t_loop, "gather_group", corrupt)
    got = exp_train_gather_probe.main(["--frames", "1280", "--groups", "1", "--out", "t.json",
                                       "--device", "cpu"])
    assert got["mismatch_count"] == 1 and got["mismatches"] == [
        {"group": 0, "batch": 16, "kind": "images"}]


def test_exp_page2_identity_matches_jax(patched, capsys):
    argv = ["--frames", "600", "--groups", "1"]
    jax_module("exp_page2_identity").main(argv + ["--out", "j.json"])
    got = exp_page2_identity.main(argv + ["--out", "t.json", "--device", "cpu"])
    with open("j.json") as f:
        want = json.load(f)
    assert want["groups"] == got["groups"] == 1
    for k in ("params_equal_AB", "params_equal_BC"):
        assert want[k] is got[k] is True, k
    assert got["loss_maxdiff_AB"] == got["loss_maxdiff_BC"] == 0.0
    assert got["losses_equal_AB"] and got["losses_equal_BC"]
    np.testing.assert_allclose(got["lossA_head"][0], want["lossA_head"][0], **LOSS_TOL)
    assert got["lossA_head"] == got["lossC_head"]
    assert "page-2 addressing faithful" in capsys.readouterr().out


def test_page2_identity_control_run_and_a_distinct_page(patched):
    """The control run A' equals A, and page 2 must be its own allocation:
    the same tensor twice is refused."""
    pages, page_rows, shape, labels = patched[600]
    _, tt = tables(pages, page_rows, shape, labels)
    page = tt["images"][0]
    got = exp_page2_identity.identity(page, page.clone(), tt, labels, page_rows, T_CFG, 1,
                                      torch.device("cpu"), runs=("A", "A'"))
    assert got["params_equal_AA2"] and got["losses_equal_AA2"]
    with pytest.raises(ValueError, match="distinct allocation"):
        exp_page2_identity.identity(page, page, tt, labels, page_rows, T_CFG, 1,
                                    torch.device("cpu"))


def test_exp_eval_page_mutation_matches_jax(patched):
    argv = ["--frames", "2800", "--rounds", "1"]
    jax_module("exp_eval_page_mutation").main(argv + ["--out", "j.json"])
    got = exp_eval_page_mutation.main(argv + ["--out", "t.json", "--device", "cpu"])
    with open("j.json") as f:
        want = json.load(f)
    # Each page's hash is the JAX tool's, exactly, before and after.
    assert got["init"] == want["init"] and len(set(got["init"])) == 2
    assert got["rounds"] == want["rounds"]
    assert want["mutated"] is got["mutated"] is False
    assert got["eval_groups_per_round"] == 1


def test_exp_eval_sideeffect_matches_jax(patched, capsys):
    """A 900-row table: the safe rows (< 150,000) past its end clamp to its
    last physical row in both packages."""
    argv = ["--frames", "900", "--rounds", "1", "--group", "2"]
    jax_module("exp_eval_sideeffect").main(argv)
    want = capsys.readouterr().out
    got = exp_eval_sideeffect.main(argv + ["--interleave-train", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"params fingerprint before: {got['fingerprint_before']}" in want
    assert got["fingerprint_before"] == got["fingerprint_after"]
    for verdict in ("params unchanged", "safe-eval outputs stable",
                    "crossing-eval deterministic across calls: True"):
        assert verdict in want and verdict in out, verdict
    assert got["params_unchanged"] and got["safe_eval_stable"] and got["crossing_deterministic"]
    jloss = float(want.split("safe-eval loss[0] ")[1].split()[0])
    np.testing.assert_allclose(got["safe_loss_first"], jloss, **LOSS_TOL)


def test_exp_dispatch_divergence_matches_jax(patched):
    """The JAX tool's phase on the small table against the port's main on
    the small table and on the big one whose prefix it is."""
    idxs = np.random.RandomState(7).randint(0, 600, size=(25, 120)).astype(np.int32)
    want = jax_module("exp_dispatch_divergence").run_phase(600, idxs, 0)
    got = exp_dispatch_divergence.main(["--small", "600", "--big", "1200", "--out", "t.json",
                                        "--device", "cpu"])
    assert got["all_equal"] and got["checksum_steps_differing"] == 0
    assert got["small"]["checksums"] == got["big"]["checksums"] == want["checksums"]
    assert got["small"]["losses"] == got["big"]["losses"]
    np.testing.assert_allclose(got["small"]["losses"][0], want["losses"][0], **LOSS_TOL)


def test_gather_group_clamps_the_labels():
    """The loop's group gather (``data.resident.gather_group``): rows past a
    one-page table's end read its last physical frame (XLA's clamp, the
    kernel's) and its last labels; rows below 0 its first."""
    pages, labels = synthetic(50, FRAME, 50, seed=9)
    _, tt = tables(pages, 50, FRAME, labels)
    table = {**tt, "images": tt["images"][0]}
    got = t_resident.gather_group(table, np.array([[0, 49, 50, 10 ** 6, -3]]))
    last = len(pages[0]) - 1
    np.testing.assert_array_equal(got["images"].reshape(5, -1).numpy(),
                                  pages[0][[0, 49, 50, last, 0]])
    np.testing.assert_array_equal(got["command"].numpy(), labels["command"][[0, 49, 49, 49, 0]])
    assert os.environ.get("CILRS_TPU_ALLOW_BIG_TABLE") is None
